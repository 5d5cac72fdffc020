"""K2 (`unpack_codes`) and the cold tier's codecs against the JAX package.

On CPU tensors the port's wrapper takes its plain torch version; it must
equal the Pallas kernel, run here in interpret mode (its CPU default),
exactly, at every packed width and across sizes, and round-trip the JAX
package's `pack_codes`.  The CUDA kernel itself runs only on a card
(tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tidb_tpu.copr import pallas as jpallas
from tidb_tpu.copr import fusion as jfusion
from tidb_tpu.layout.coldtier import pack_codes
from tidb_tpu_torch import ops as tops
from tidb_tpu_torch.copr import cuda as tcuda
from tidb_tpu_torch.copr import fusion as tfusion
from tidb_tpu_torch.layout import coldtier as tcold


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    tops.use_device("cpu")


def _codes(bits: int, n: int, seed: int = 3):
    rng = np.random.default_rng(seed + bits * 7 + n)
    return rng.integers(0, 1 << bits, n).astype(np.uint8)


@pytest.mark.parametrize("n", [8, 1024, 65536, 16 * 1000 + 8])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_unpack_codes_matches_pallas_kernel(bits, n):
    codes = _codes(bits, n)
    packed = pack_codes(codes, bits)
    want = np.asarray(jpallas.unpack_codes(jnp.asarray(packed), bits, n))
    before = tcuda.unpack_codes.launches
    got = tcuda.unpack_codes(torch.from_numpy(packed), bits, n).numpy()
    assert got.dtype == np.uint8 and got.shape == (n,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, codes)  # round trip of pack_codes
    np.testing.assert_array_equal(
        tcuda.unpack_codes_plain(torch.from_numpy(packed), bits, n).numpy(),
        want)
    # CPU tensors take the plain version: no kernel launch is counted
    assert tcuda.unpack_codes.launches == before == 0


def test_unpack_codes_rejects_bad_inputs():
    p = torch.zeros(16, dtype=torch.uint8)
    with pytest.raises(ValueError):
        tcuda.unpack_codes(p, 4, 33)  # 16 bytes at 4 bits hold 32 rows
    with pytest.raises(TypeError):
        tcuda.unpack_codes(p.to(torch.int32), 4, 32)
    with pytest.raises(ValueError):
        tcuda.unpack_codes(p, 3, 16)
    with pytest.raises(ValueError):
        tcuda.unpack_codes(torch.zeros(32, dtype=torch.uint8)[::2], 4, 32)
    # a bias must be a 0-d int32 or int64 tensor on packed's device
    with pytest.raises(TypeError):
        tcuda.unpack_codes(p, 4, 32, bias=torch.tensor(1.5))
    with pytest.raises(ValueError):
        tcuda.unpack_codes(p, 4, 32,
                           bias=torch.tensor([7], dtype=torch.int64))
    with pytest.raises(ValueError):
        tcuda.unpack_codes(p, 4, 32, bias=torch.tensor(
            7, dtype=torch.int64, device="meta"))
    assert tcuda.unpack_codes.launches == 0


@pytest.mark.parametrize("kind", ["range", "unique", "range-i32",
                                  "range-neg"])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_decode_packed_matches_reference(bits, kind):
    """A range column decodes through K2's fused form (code + bias in one
    call), a unique one through the bare K2 and a gather; both equal the
    JAX package's decode, dtype included."""
    n = 4096
    codes = _codes(bits, n, seed=9)
    packed = pack_codes(codes, bits)
    if kind.startswith("range"):
        bias, dt = {"range": (1234, np.int64), "range-i32": (1234, np.int32),
                    "range-neg": (-(1 << 40), np.int64)}[kind]
        jarg = jnp.asarray(np.array(bias, dtype=dt))
        targ = torch.from_numpy(np.array(bias, dtype=dt))
        kind = "range"
    else:
        vals = np.sort(np.random.default_rng(1).random(1 << bits))
        jarg, targ = jnp.asarray(vals), torch.from_numpy(vals)
    want = np.asarray(jfusion.decode_packed(jnp.asarray(packed), jarg,
                                            bits, n, kind=kind))
    got = tfusion.decode_packed(torch.from_numpy(packed), targ, bits, n,
                                kind=kind).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert tcuda.unpack_codes.launches == 0


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_device_demote_encoder_matches_host_packing(bits):
    """The on-card re-encode (eviction to the cold tier) packs the same
    bytes as the host compress path, pad rows included."""
    n, base_rows, lo = 2048, 2000, -3
    vals = _codes(bits, n, seed=5).astype(np.int64) + lo
    enc = tcold._demote_encoder("range", bits, 1 << bits, lo, base_rows)
    got = enc(torch.from_numpy(vals)).numpy()
    host = np.clip(vals - lo, 0, (1 << bits) - 1).astype(np.uint8)
    host[base_rows:] = 0
    np.testing.assert_array_equal(got, pack_codes(host, bits))
