"""The f32 route of the flash-attention kernels (``ray_tpu_torch.ops``),
split TF32 emulated on the CPU, and the f32 forward's online softmax
emulated at the kernel's own tiles.

Split TF32 carries an f32 product on the tensor cores at a third of their
TF32 rate: each operand x is hi = tf32(x) and lo = tf32(x - hi), rounded
to nearest with ties away (``cvt.rna.tf32.f32``), and A.B = Alo.Bhi +
Ahi.Blo + Ahi.Bhi. Here it is put into copies of the plain versions
(``attention._bwd_dq_plain``, ``_bwd_dkv_plain``) as their output products
(S and dP stay f32) and held to the same copies with those products in
f64, on the same f32 inputs, by ``kernel_check.compare`` at its unchanged
f32 bounds: it meets them, and one TF32 pass fails them hundreds of times
over. The f32 kernels do not use it: the rule holds them to the plain
version itself, whose cuBLAS fma chains carry about 1e-6 of error at
S=2048, so ``ops/csrc/flash_bwd_dq.cu`` and ``flash_bwd_dkv.cu`` sum every
product in that order on the CUDA cores, which a CPU test pins. The f32
forward (``flash_fwd.cu``) sums its two products the same way, but its
online softmax rescales O tile by tile: ``online_fwd`` emulates that at the
kernel's 64-key tiles and holds it to ``attention._fwd_plain`` under the
unchanged f32 ``o`` rule. The tests marked ``cuda`` run the kernels on the
card and skip here.
"""

import math
import re

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.tools import kernel_check

torch.set_num_threads(1)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32``: add half of the dropped 13 bits' range
    to the bit pattern, then clear them (the sign bit is untouched)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple:
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm_split_tf32(a, b):
    """A.B in split TF32, the small terms first (as ``mma_split_tf32``)."""
    (ahi, alo), (bhi, blo) = split(a), split(b)
    return (alo @ bhi + ahi @ blo) + ahi @ bhi


def mm_one_pass_tf32(a, b):
    return tf32_rna(a) @ tf32_rna(b)


def mm_f64(a, b):
    return a.double() @ b.double()


def bwd_dq(mm, q, k, v, do, lse, delta, causal, sc, h, hk):
    """``_bwd_dq_plain`` with ``mm`` for dS.K; S and dP in f32."""
    kx, vx = tattn._expand_kv(k, h, hk), tattn._expand_kv(v, h, hk)
    _, ds = tattn._dS_plain(q, kx, vx, do, lse, delta, causal, sc)
    return mm(ds, kx)


def bwd_dkv(mm, q, k, v, do, lse, delta, causal, sc, h, hk):
    """``_bwd_dkv_plain`` with ``mm`` for P^T.dO and dS^T.Q; S and dP in
    f32; the group sum in the product's dtype."""
    kx, vx = tattn._expand_kv(k, h, hk), tattn._expand_kv(v, h, hk)
    p, ds = tattn._dS_plain(q, kx, vx, do, lse, delta, causal, sc)
    dv = mm(p.transpose(-1, -2), do)
    dk = mm(ds.transpose(-1, -2), q)
    return tattn._group_sum(dk, h, hk), tattn._group_sum(dv, h, hk)


def inputs(b, h, hk, s, d, causal, seed):
    """q, k, v, dO standard normal from a seeded numpy RandomState, and the
    f32 lse and delta the plain forward gives them."""
    rng = np.random.RandomState(seed)
    q, do = (torch.from_numpy(rng.randn(b * h, s, d).astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(b * hk, s, d).astype(np.float32)) for _ in range(2))
    sc = 1.0 / math.sqrt(d)
    o, lse = tattn._fwd_plain(q, k, v, causal, sc, h, hk)
    delta = (do * o).sum(dim=-1, keepdim=True)
    return (q, k, v, do, lse, delta, causal, sc, h, hk)


#: (h, hk, s, d, causal): MHA and GQA, causal and not, ragged S, d = 16 (the
#: tiny config's) and 128 (the training width)
CASES = [(h, hk, s, d, causal) for d in (16, 128)
         for h, hk, s, causal in [(2, 2, 128, True), (4, 2, 100, False), (4, 1, 130, True),
                                  (2, 2, 96, False)]]


def readings(mm, case, seed=0):
    """dq, dk, dv with ``mm`` for the output products, each against the
    same copy with them in f64, by ``kernel_check.compare`` (f32 bounds)."""
    h, hk, s, d, causal = case
    args = inputs(2, h, hk, s, d, causal, seed)
    out = {"dq": kernel_check.compare(bwd_dq(mm, *args), bwd_dq(mm_f64, *args), "float32", "grad")}
    dk, dv = bwd_dkv(mm, *args)
    rdk, rdv = bwd_dkv(mm_f64, *args)
    out["dk"] = kernel_check.compare(dk, rdk, "float32", "grad")
    out["dv"] = kernel_check.compare(dv, rdv, "float32", "grad")
    return out


@pytest.mark.parametrize("case", CASES, ids=lambda c: "h{}-hk{}-s{}-d{}-{}".format(
    *c[:4], "causal" if c[4] else "full"))
def test_split_tf32_meets_f32_bounds(case):
    """The three-pass product carries an operand to about 22 bits: dq, dk
    and dv stay within the f32 rule (1e-5 scaled, 1e-6 relative RMS) of the
    f64 products, at least 2x under the RMS bound (1.4e-7 to 2.7e-7 here)."""
    for what, r in readings(mm_split_tf32, case).items():
        assert r["ok"], (what, r)
        assert r["rel_rms_err"] < 0.5 * kernel_check.TOL["float32"]["grad"]["rel_rms"], (what, r)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "h{}-hk{}-s{}-d{}-{}".format(
    *c[:4], "causal" if c[4] else "full"))
def test_one_pass_tf32_fails_f32_bounds(case):
    """One TF32 pass keeps 11 bits of each operand: every gradient reads
    hundreds of times over the RMS bound, which is why the f32 route splits."""
    for what, r in readings(mm_one_pass_tf32, case).items():
        assert not r["ok"], (what, r)
        assert r["rel_rms_err"] > 100 * kernel_check.TOL["float32"]["grad"]["rel_rms"], (what, r)


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = 1.0
    x = torch.tensor([one + 2.0 ** -11, one + 2.0 ** -12, -(one + 2.0 ** -11),
                      one + 3 * 2.0 ** -12, 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([one + 2.0 ** -10, one, -(one + 2.0 ** -10), one + 2.0 ** -10, 3.0, 0.0],
                        dtype=torch.float32)
    assert torch.equal(tf32_rna(x), want)
    assert not (tf32_rna(torch.randn(1000)).view(torch.int32) & 0x1FFF).any()


def test_split_carries_22_bits():
    x = torch.from_numpy(np.random.RandomState(3).randn(4096).astype(np.float32))
    hi, lo = split(x)
    assert torch.equal(hi, tf32_rna(x)) and torch.equal(lo, tf32_rna(x - hi))
    err = ((hi.double() + lo.double()) - x.double()).abs() / x.double().abs()
    assert float(err.max()) <= 2.0 ** -22
    assert float(((hi.double() - x.double()).abs() / x.double().abs()).max()) <= 2.0 ** -11


def test_f32_route_name_and_kernels_sum_in_the_plain_order():
    """f32 takes the ``cuda_core`` route: its dq and dk/dv kernels compute
    S and dP with ``mm_rows_f32`` and every output product with
    ``mm_pb_f32`` (no TF32 anywhere), each element one ``fmaf`` chain from
    0 over the reduced index ascending, as a sequential f32 GEMM sums."""
    from ray_tpu_torch.ops import _build

    assert tattn.kernel_route(torch.float32) == "cuda_core"
    assert tattn.kernel_route(torch.bfloat16) == "tensor_core"
    for name, outputs in (("flash_bwd_dq.cu", 1), ("flash_bwd_dkv.cu", 1)):
        src = re.sub(r"//[^\n]*", "", (_build.CSRC / name).read_text())  # the code alone
        assert src.count("mm_rows_f32<D, ") == 1 and src.count("mm_pb_f32<D, ") == outputs, name
        assert "tf32" not in src.lower() and "mma" not in src, name
    hop = (_build.CSRC / "hopper.cuh").read_text()
    for fn in ("mm_rows_f32", "mm_pb_f32"):
        body = hop[hop.index(f"void {fn}("):]
        body = body[:body.index("\n}\n")]
        assert re.search(r"for \(int (c|k) = 0; \1 < \w+; \1 \+= 4\)", body), fn
        assert re.search(r"acc\[i\]\[j\] = fmaf\(.*, acc\[i\]\[j\]\);", body), fn


def test_f32_forward_is_a_tma_ring_of_exact_f32_products():
    """The f32 forward loads by TMA into an ``mbarrier`` ring fed by a
    producer warp and computes on consumer warpgroups: S with
    ``mm_rows_f32`` and O += P.V with ``mm_pb_f32``, exact f32 ``fmaf``
    chains (no TF32, no ``mma``), a stage released after P.V, the last
    product that reads it. ``flash_common.cuh`` is gone: no source includes
    it."""
    from ray_tpu_torch.ops import _build

    src = re.sub(r"//[^\n]*", "", (_build.CSRC / "flash_fwd.cu").read_text())
    kernel = src[src.index("flash_fwd_kernel(const "):src.index("\nint fwd_launch(")]
    assert kernel.count("mm_rows_f32<D, ") == 1 and kernel.count("mm_pb_f32<D, ") == 1
    assert "tf32" not in src.lower() and "mma" not in src
    for piece in ("tma_load_3d(", "mbar_expect_tx(", "mbar_wait(full_bar(s)", "setmaxnreg_dec<",
                  "setmaxnreg_inc<"):
        assert piece in kernel, piece
    assert kernel.count("mbar_arrive(empty_bar(s));") == 1
    assert kernel.index("mm_pb_f32<D, ") < kernel.index("mbar_arrive(empty_bar(s));")
    assert not (_build.CSRC / "flash_common.cuh").exists()
    for path in sorted(_build.CSRC.iterdir()):
        assert "flash_common" not in path.read_text(), path.name


def online_fwd(q, k, v, causal, sc, h, hk, bn=64, half=32):
    """The f32 kernel's forward emulated in torch: key tiles of ``bn``, a
    running max m and sum l per row (masked scores at -1e30, masked p = 0),
    O rescaled by alpha = exp(m_old - m_new) before each tile's P.V, which
    adds the tile in halves of ``half`` keys; o = O / max(l, 1e-30), lse =
    m + log(max(l, 1e-30))."""
    kx, vx = tattn._expand_kv(k, h, hk), tattn._expand_kv(v, h, hk)
    scores = tattn._scores(q, kx, causal, sc)
    sq, sk = scores.shape[-2:]
    keep = torch.ones(sq, sk, dtype=torch.bool).tril() if causal else torch.ones(sq, sk, dtype=torch.bool)
    m = torch.full((q.shape[0], sq, 1), tattn._NEG_INF)
    l = torch.zeros(q.shape[0], sq, 1)
    acc = torch.zeros(q.shape[0], sq, q.shape[-1])
    for k0 in range(0, sk, bn):
        s, kp = scores[..., k0:k0 + bn], keep[:, k0:k0 + bn]
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(kp, torch.exp(s - m_new), torch.zeros(()))
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha
        for h0 in range(0, p.shape[-1], half):
            acc = acc + p[..., h0:h0 + half] @ vx[:, k0 + h0:k0 + h0 + half]
        m = m_new
    lc = l.clamp_min(1e-30)
    return acc / lc, m + torch.log(lc)


#: (b, h, hk, s, d, causal): the main shape's length and width at fewer
#: heads, causal and not, GQA, a ragged S, and the tiny config's d = 16
FWD_CASES = [(1, 4, 4, 2048, 128, True), (1, 4, 2, 2048, 128, False), (1, 4, 1, 1000, 128, True),
             (2, 4, 2, 256, 16, True)]


@pytest.mark.parametrize("case", FWD_CASES, ids=lambda c: "b{}-h{}-hk{}-s{}-d{}-{}".format(
    *c[:5], "causal" if c[5] else "full"))
def test_online_softmax_at_kernel_tiles_meets_f32_o_rule(case):
    """The rescaling of the online softmax is the only order in which the
    f32 forward differs from the plain version: at the kernel's tiles it
    stays within the f32 ``o`` rule (1e-5 scaled, 1e-6 relative RMS), at
    half the RMS bound or less, and lse within ``LSE_ATOL``."""
    b, h, hk, s, d, causal = case
    rng = np.random.RandomState(7)
    q = torch.from_numpy(rng.randn(b * h, s, d).astype(np.float32))
    k, v = (torch.from_numpy(rng.randn(b * hk, s, d).astype(np.float32)) for _ in range(2))
    sc = 1.0 / math.sqrt(d)
    o, lse = online_fwd(q, k, v, causal, sc, h, hk)
    po, plse = tattn._fwd_plain(q, k, v, causal, sc, h, hk)
    r = kernel_check.compare(o, po, "float32", "o")
    assert r["ok"], r
    assert r["rel_rms_err"] <= 0.5 * kernel_check.TOL["float32"]["o"]["rel_rms"], r
    assert float((lse - plse).abs().max()) <= kernel_check.LSE_ATOL


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README, PyTorch/CUDA port)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d", tattn.KERNEL_HEAD_DIMS)
def test_cuda_f32_backward_same_bits_twice(cuda_device, d):
    """No atomics, no order that depends on scheduling: two calls of each
    f32 backward kernel give the same bits (GQA, ragged, causal)."""
    q, k, v, do = kernel_check.make_inputs(2, 4, 2, 200, d, "float32", seed=4)
    kw = dict(causal=True, sm_scale=1.0 / math.sqrt(d), h=4, hk=2)
    o, lse = tattn.flash_fwd(q, k, v, **kw)
    delta = (do * o).sum(dim=-1, keepdim=True)
    assert torch.equal(tattn.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
                       tattn.flash_bwd_dq(q, k, v, do, lse, delta, **kw))
    for a, b in zip(tattn.flash_bwd_dkv(q, k, v, do, lse, delta, **kw),
                    tattn.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("d", tattn.KERNEL_HEAD_DIMS)
def test_cuda_f32_forward_same_bits_twice(cuda_device, d):
    """No atomics, no order that depends on scheduling: two calls of the f32
    forward give the same o and lse bits (GQA, ragged, causal and not)."""
    for causal in (True, False):
        q, k, v, _ = kernel_check.make_inputs(2, 4, 2, 200, d, "float32", seed=5)
        kw = dict(causal=causal, sm_scale=1.0 / math.sqrt(d), h=4, hk=2)
        o1, l1 = tattn.flash_fwd(q, k, v, **kw)
        o2, l2 = tattn.flash_fwd(q, k, v, **kw)
        assert torch.equal(o1, o2) and torch.equal(l1, l2), causal


@pytest.mark.cuda
def test_cuda_f32_fwd_refuses_misaligned(cuda_device):
    """The f32 forward reads q, k and v by TMA: an f32 view of any of them
    that starts off a 16-byte boundary is refused, not read misaligned."""
    buf = torch.randn(2 * 128 * 64 + 1, device=cuda_device)
    bad = buf[1:].view(2, 128, 64)
    ok = torch.randn(2, 128, 64, device=cuda_device)
    for i in range(3):
        args = [ok] * 3
        args[i] = bad
        with pytest.raises(ValueError, match="16-byte"):
            tattn.flash_fwd(*args, causal=True, sm_scale=0.125, h=2, hk=2)


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", ["flash_bwd_dq", "flash_bwd_dkv"])
def test_cuda_f32_bwd_refuses_misaligned(cuda_device, wrapper):
    """The f32 backward kernels read q, k, v and dO by TMA: an f32 view
    that starts off a 16-byte boundary is refused, not read misaligned."""
    buf = torch.randn(2 * 128 * 64 + 1, device=cuda_device)
    bad = buf[1:].view(2, 128, 64)
    ok = torch.randn(2, 128, 64, device=cuda_device)
    rows = torch.zeros(2, 128, 1, device=cuda_device)
    for i in range(4):
        args = [ok] * 4
        args[i] = bad
        with pytest.raises(ValueError, match="16-byte"):
            getattr(tattn, wrapper)(*args, rows, rows, causal=True, sm_scale=0.125, h=2, hk=2)


def test_kernel_check_holds_the_f32_route():
    """``kernel_check`` runs the f32 kernels in three cases (the main
    shape, GQA with 8 kv heads, a ragged S=1000), breaks each f32 kernel's
    ring, the forward's rescale and the GQA order in copies that must fail
    them, and sums
    the f32 margins of a seed sweep apart from the bf16 ones."""
    f32 = ("f32", "f32_gqa", "f32_s1000")
    assert all(kernel_check.CASES[c] == dict(kernel_check.MAIN, dtype="float32",
                                             **({"hk": 8} if c == "f32_gqa" else
                                                {"s": 1000} if c == "f32_s1000" else {}))
               for c in f32)
    for name in ("dq_f32_release_before_products", "dkv_f32_release_before_products",
                 "fwd_f32_release_before_pv"):
        assert kernel_check.MUTANTS[name][3] == f32, name
    assert kernel_check.MUTANTS["fwd_f32_skip_alpha_rescale"][3] == f32 + ("tiny",)
    assert kernel_check.MUTANTS["dkv_f32_one_chain"][3] == ("f32_gqa",)

    def row(case, seed, rms, scaled):
        return {"variant": "sound", "case": case, "seed": seed,
                "rel_rms_err": {"dq": rms, "dk": rms / 2, "dv": 0.0},
                "max_scaled_err": {"dq": scaled, "dk": 0.0, "dv": 0.0},
                "o": {"max_scaled_err": 1e-3, "rel_rms_err": 1e-4}}

    out = kernel_check.sweep_summary([row("main", 0, 1e-4, 1e-3), row("f32_gqa", 3, 2e-7, 1e-6),
                                      row("f32", 1, 1e-7, 3e-6)])
    assert out["sound_worst"]["case"] == "main"
    worst = out["f32"]["rel_rms_err"]
    assert (worst["case"], worst["seed"], worst["grad"]) == ("f32_gqa", 3, "dq")
    assert worst["bound_over_worst"] == pytest.approx(1e-6 / 2e-7)
    assert out["f32"]["max_scaled_err"]["case"] == "f32"


def test_f32_bounds_at_both_rates():
    """The f32 kernels' bound is their FLOPs over the CUDA cores' 67
    TFLOP/s (the design that runs), recorded beside split TF32's: three
    TF32 passes a product at 494.7 TFLOP/s."""
    c = dict(kernel_check.MAIN, dtype="float32")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_bwd"):
        b = kernel_check.f32_bounds(name, c)
        assert b["bound_by"] == "operations", name
        assert b["bound_ms"] == pytest.approx(1e3 * b["flops"] / 67e12), name
        assert b["bound_ms_split_tf32"] == pytest.approx(1e3 * 3 * b["flops"] / 494.7e12), name
