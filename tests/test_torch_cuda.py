"""The port's CUDA kernels and device path on a card.

Every test here is marked `cuda` and skips without a CUDA device (a
CUDA kernel has no CPU mode; its plain version is what the CPU tests
check).  The file imports neither jax nor the JAX package, so it runs
on a machine with the card, without tests/conftest.py (which imports
jax):

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest
"""

import numpy as np
import pytest
import torch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from tidb_tpu_torch import ops

    ops.use_device("cuda")
    yield torch.device("cuda")
    ops.use_device("cpu")


def _packed(bits: int, n: int, seed: int = 3):
    from tidb_tpu_torch.layout.coldtier import pack_codes

    codes = np.random.default_rng(seed + bits).integers(
        0, 1 << bits, n).astype(np.uint8)
    return codes, pack_codes(codes, bits)


#: (bits, bias): the bare form at 1, 2 and 4 bits (8 bits bare is the
#: identity and launches nothing), the fused range decode at every width
#: with a negative int32 and an int64 bias beyond 32 bits
UNPACK_FORMS = ([(b, None) for b in (1, 2, 4)]
                + [(b, (-7, torch.int32)) for b in (1, 2, 4, 8)]
                + [(b, ((1 << 40) + 3, torch.int64)) for b in (1, 2, 4, 8)])


@pytest.mark.cuda
@pytest.mark.parametrize("offset", range(8))
@pytest.mark.parametrize("n", [8, 1 << 20, (1 << 20) + 8])
@pytest.mark.parametrize("bits,bias", UNPACK_FORMS)
def test_unpack_codes_kernel_matches_plain(card, bits, bias, n, offset):
    """K2 on the card equals its plain version exactly, bare and fused,
    for a packed slice that starts `offset` bytes past an aligned
    address and for a ragged n (not a multiple of 16)."""
    from tidb_tpu_torch.copr.cuda import unpack_codes, unpack_codes_plain

    codes, packed = _packed(bits, n)
    buf = torch.zeros(packed.size + 16, dtype=torch.uint8, device=card)
    p = buf[offset:offset + packed.size]
    p.copy_(torch.from_numpy(packed))
    b = None if bias is None else torch.tensor(bias[0], dtype=bias[1],
                                                device=card)
    before = unpack_codes.launches
    got = unpack_codes(p, bits, n, bias=b)
    torch.cuda.synchronize()
    assert unpack_codes.launches == before + 1
    assert got.dtype == (torch.uint8 if b is None else b.dtype)
    assert torch.equal(got, unpack_codes_plain(p, bits, n, bias=b))
    want = codes if b is None else codes.astype(np.int64) + bias[0]
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
def test_unpack_codes_rejects_bad_length_on_card(card):
    from tidb_tpu_torch.copr.cuda import unpack_codes

    with pytest.raises(ValueError):
        unpack_codes(torch.zeros(4, dtype=torch.uint8, device=card), 4, 9)


@pytest.mark.cuda
@pytest.mark.parametrize("map_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("code_dtype", [torch.uint8, torch.int8, torch.int16,
                                        torch.int32, torch.int64])
def test_remap_codes_kernel_matches_plain(card, code_dtype, map_dtype):
    """K1 on the card against its plain version: both kernel branches
    (a mapping staged in shared memory, and one read through __ldg) and
    codes outside [0, cap)."""
    from tidb_tpu_torch.copr.cuda import remap_codes, remap_codes_plain

    g = torch.Generator(device=card).manual_seed(5)
    info = torch.iinfo(code_dtype)
    for cap in (2, 4, 1 << 12, 1 << 16, 1 << 22):
        for n in (8, (1 << 20) + 3):
            lo = max(info.min, -7)
            hi = min(info.max, cap + 40)
            codes = torch.randint(lo, hi + 1, (n,), device=card,
                                  generator=g).to(code_dtype)
            mapping = torch.randint(-(1 << 31), 1 << 31, (cap,),
                                    device=card, generator=g).to(map_dtype)
            before = remap_codes.launches
            got = remap_codes(codes, mapping, n)
            torch.cuda.synchronize()
            assert remap_codes.launches == before + 1
            assert got.dtype == map_dtype
            assert torch.equal(got, remap_codes_plain(codes, mapping, n))


@pytest.mark.cuda
@pytest.mark.parametrize("descending", [True, False])
def test_masked_top_k_orders_ties_by_row_on_card(card, descending):
    from tidb_tpu_torch.ops import masked_top_k

    g = torch.Generator(device=card).manual_seed(9)
    n = 1 << 20
    key = torch.randint(0, 50, (n,), device=card, generator=g).double()
    mask = torch.rand(n, device=card, generator=g) > 0.3
    for k in (1, 16, 1024):
        idx, cnt = masked_top_k(key, mask, k, descending)
        kf = key if descending else -key
        kf = torch.where(mask, kf, torch.full_like(kf, float("-inf")))
        want = torch.sort(kf, descending=True, stable=True).indices[:k]
        assert int(cnt) == k
        assert torch.equal(idx, want)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [33, 100, 4097])
def test_float_segment_sums_are_bit_identical_on_card(card, G):
    """Float sums above UNROLL_G (a stable sort of the group codes and a
    direct per-span sum, no atomics) give the same bits in 5 runs on
    the card, solo and as a batch of 4 masks, and agree with the CPU
    within relative 1e-12 plus 1e-3 absolute (two summation orders of
    up to ~5e5 values of magnitude <= 5e5 differ by ~1e-4 at most)."""
    from tidb_tpu_torch.ops import masked_segment_sum

    n = 1 << 24
    g = torch.Generator(device=card).manual_seed(17)
    data = (torch.rand(n, device=card, generator=g, dtype=torch.float64)
            - 0.5) * 1e6
    gidx = torch.randint(0, G, (n,), device=card, generator=g)
    masks = torch.rand(4, n, device=card, generator=g) < 0.7
    for mask in (masks[0], masks):
        runs = [masked_segment_sum(data, gidx, mask, G).cpu().numpy()
                for _ in range(5)]
        for r in runs[1:]:
            assert r.tobytes() == runs[0].tobytes()
        host = masked_segment_sum(data.cpu(), gidx.cpu(), mask.cpu(),
                                  G).numpy()
        np.testing.assert_allclose(runs[0], host, rtol=1e-12, atol=1e-3)


@pytest.mark.cuda
def test_two_shard_mesh_on_card_equals_one_shard(card):
    """Q6 from SQL and a pair join's exchange at
    `use_device("cuda", shards=2)` (two mesh positions on the one card)
    give the rows of S = 1; `exchange` moves each bucket to its shard."""
    from tidb_tpu_torch import ops
    from tidb_tpu_torch.copr import parallel as pl
    from tidb_tpu_torch.mpp import exchange as ex
    from tidb_tpu_torch.tpch_data import LINEITEM_Q6, build_lineitem

    sess = build_lineitem(1 << 20, regions=4, seed=7)
    sess.execute("set tidb_use_tpu = 1")
    one = sess.query(LINEITEM_Q6)
    try:
        ops.use_device("cuda", shards=2)
        two = sess.query(LINEITEM_Q6)
        assert pl._MESH is not None and pl._MESH.size == 2
        g = torch.Generator(device=card).manual_seed(5)
        packs = [torch.randint(0, 99, (2, 1000), device=card, generator=g)
                 for _ in range(2)]
        recv = ex.exchange(packs)
        for d in range(2):
            assert torch.equal(recv[d], torch.cat([packs[0][d],
                                                   packs[1][d]]))
    finally:
        ops.use_device("cuda")
    assert one and two == one


_TWO_PROCS = r"""
import os, sys
import torch
pid, port = int(sys.argv[1]), sys.argv[2]
os.environ.update(TIDB_TPU_COORDINATOR=f"127.0.0.1:{port}",
                  TIDB_TPU_NUM_PROCESSES="2", TIDB_TPU_PROCESS_ID=str(pid),
                  TIDB_TPU_DIST_TIMEOUT_S="60")
from tidb_tpu_torch import ops
from tidb_tpu_torch.copr import parallel as pl
from tidb_tpu_torch.mpp import exchange as ex
ops.use_device("cuda", shards=2)
pl._maybe_init_multihost()
import torch.distributed as dist
assert dist.get_backend() == "gloo", dist.get_backend()
S, cap, dev = 4, 5, torch.device("cuda", 0)
mine = (2 * pid, 2 * pid + 1)
parts = [torch.arange(300, dtype=torch.float64, device=dev) * (s + 1) / 7
         for s in range(S)]
want = parts[0]
for p in parts[1:]:
    want = want + p
got = ops.psum(ops.gather_shards(
    [parts[s] if s in mine else None for s in range(S)]))
assert torch.equal(got, want)
packs = [torch.arange(S * cap, device=dev).reshape(S, cap) + 100 * s
         for s in range(S)]
full = ex.exchange(packs)
owners = (0, 0, 1, 1)
out = ex.exchange([packs[s] if s in mine else None for s in range(S)],
                  owners)
for s in range(S):
    assert (out[s] is None) == (s not in mine)
    if s in mine:
        assert torch.equal(out[s], full[s])
dist.destroy_process_group()
print("TWO_PROCS_OK", pid)
"""


@pytest.mark.cuda
def test_two_processes_share_the_card_over_gloo(card):
    """Two processes on the one card (gloo: NCCL refuses two ranks on
    one device), two positions each: `ops.psum` and the exchange's
    all_to_all equal their single-process results bit for bit."""
    import os
    import socket
    import subprocess
    import sys

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, "-c", _TWO_PROCS, str(p),
                               str(port)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for p in (0, 1)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "TWO_PROCS_OK" in out, out[-3000:]


@pytest.mark.cuda
def test_kernel_family_on_card_is_clean_against_the_cuda_baseline(card):
    """The lint's kernel family on the card: every canonical program runs,
    K1 and K2 equal their plain versions, no op sequence moves with
    operand values or context, a re-run of the corpus adds no program
    and starts no nvcc build, and no program's int64 ops grow past the
    baseline's `cuda` section."""
    from tidb_tpu_torch.lint.baseline import kernel_stats, load_baseline
    from tidb_tpu_torch.lint.kernelcheck import lint_kernels

    base = kernel_stats(load_baseline(), "cuda")
    assert base, "the lint baseline has no cuda section"
    findings = lint_kernels(baseline_kernels=base, device="cuda")
    assert not findings, "\n".join(f.render() for f in findings)
