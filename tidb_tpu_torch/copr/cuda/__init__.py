"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

K1 and K2 each replace one TPU kernel of the JAX package; K3
(`dense_agg`) replaces a composition of jnp ops, which the JAX package
leaves to its compiler.  Each has:
a CUDA C++ source under ``csrc/`` built by nvcc at first use
(``build.py``); a wrapper that checks its inputs, launches on the
current stream and counts its launches; and a plain PyTorch version of
the same function that the wrapper takes for CPU tensors.

``KERNELS`` lists them for the chip smoke run and PERF.md.
"""

from .build import build_all, ptxas_report, sources  # noqa: F401
from .dense_agg import dense_agg, dense_agg_plain  # noqa: F401
from .remap import remap_codes, remap_codes_plain  # noqa: F401
from .unpack import unpack_codes, unpack_codes_plain  # noqa: F401

#: name -> (wrapper, plain version, CUDA source, TPU kernel it replaces
#: or None)
KERNELS = {
    "remap_codes": (
        remap_codes, remap_codes_plain,
        "tidb_tpu_torch/copr/cuda/csrc/remap_codes.cu",
        "tidb_tpu/copr/pallas/kernels.py:81",
    ),
    "unpack_codes": (
        unpack_codes, unpack_codes_plain,
        "tidb_tpu_torch/copr/cuda/csrc/unpack_codes.cu",
        "tidb_tpu/copr/pallas/kernels.py:114",
    ),
    "dense_agg": (
        dense_agg, dense_agg_plain,
        "tidb_tpu_torch/copr/cuda/csrc/dense_agg.cu",
        None,
    ),
}
