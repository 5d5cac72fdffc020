from .http_status import StatusServer
from .server import MySQLServer, serve_forever

__all__ = ["MySQLServer", "StatusServer", "serve_forever"]
