"""The port's attention op and layers (``ray_tpu_torch.ops``) against the
JAX package on the CPU.

Inputs are made with a seeded numpy RandomState and handed to both
frameworks. JAX's Pallas kernels run in interpret mode, as
``tests/test_attention.py`` runs them; the port runs its kernels' plain
versions, which is what its wrappers do for a CPU tensor. The CUDA kernels
themselves are checked by the ``cuda``-marked tests at the end (skipped
without a card) and by ``chip_smoke.py`` on the card.

Tolerances (f32 everywhere unless stated): outputs 2e-5 absolute — the
same arithmetic in another summation order, ~1e-7 measured; gradients
1e-4 — sums over up to 1024 keys of products of O(1) values.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jattn
from ray_tpu.ops import layers as jlayers
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.ops import layers as tlayers
from ray_tpu_torch.tools import kernel_check

torch.set_num_threads(1)

OUT_ATOL = 2e-5
GRAD_ATOL = 1e-4


def make_qkv(b=1, h=2, hk=None, s=256, d=64, seed=0):
    rng = np.random.RandomState(seed)
    hk = hk or h
    q = (rng.randn(b, h, s, d) * 0.3).astype(np.float32)
    k = (rng.randn(b, hk, s, d) * 0.3).astype(np.float32)
    v = (rng.randn(b, hk, s, d) * 0.3).astype(np.float32)
    return q, k, v


def t(x, grad=False):
    return torch.from_numpy(np.array(x)).requires_grad_(grad)


def jax_ref(q, k, v, causal):
    return jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 causal=causal, impl="xla")


@pytest.mark.parametrize("impl", ["xla", "auto"])
@pytest.mark.parametrize("causal", [True, False])
def test_forward_matches_jax_reference(causal, impl):
    q, k, v = make_qkv(s=256)
    out = tattn.flash_attention(t(q), t(k), t(v), causal=causal, impl=impl)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_ref(q, k, v, causal)), atol=OUT_ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_forward_matches_jax_pallas_kernel(causal):
    q, k, v = make_qkv(s=256, seed=1)
    ref = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                impl="pallas", block_q=128, block_k=128)
    out = tattn.flash_attention(t(q), t(k), t(v), causal=causal, impl="auto",
                                block_q=128, block_k=128)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=OUT_ATOL)


def _grads_torch(q, k, v, causal, impl, **kw):
    tq, tk, tv = t(q, True), t(k, True), t(v, True)
    (tattn.flash_attention(tq, tk, tv, causal=causal, impl=impl, **kw) ** 2).sum().backward()
    return [x.grad.numpy() for x in (tq, tk, tv)]


def _grads_jax(q, k, v, causal, impl, **kw):
    def loss(q, k, v):
        return jnp.sum(jattn.flash_attention(q, k, v, causal=causal, impl=impl, **kw) ** 2)

    return jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_function_grads_match_jax(causal):
    """The autograd.Function's plain path (dq and dk/dv plain versions)
    against jax.grad of the JAX reference."""
    q, k, v = make_qkv(s=256, seed=2)
    for a, b in zip(_grads_torch(q, k, v, causal, "auto"), _grads_jax(q, k, v, causal, "xla")):
        np.testing.assert_allclose(a, np.asarray(b), atol=GRAD_ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_gqa_forward_and_grads_match_jax(causal):
    """K/V at half the q heads: forward and gradients (dk/dv summed over the
    group) against the JAX Pallas kernels."""
    q, k, v = make_qkv(b=2, h=4, hk=2, s=256, seed=3)
    kw = dict(block_q=128, block_k=128)
    ref = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                impl="pallas", **kw)
    out = tattn.flash_attention(t(q), t(k), t(v), causal=causal, impl="auto", **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=OUT_ATOL)
    gt = _grads_torch(q, k, v, causal, "auto", **kw)
    gj = _grads_jax(q, k, v, causal, "pallas", **kw)
    for a, b in zip(gt, gj):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, np.asarray(b), atol=GRAD_ATOL)


def test_branched_mask_path_s1024():
    """>= 8 K tiles (the JAX kernels' lax.cond diagonal branch) at s=1024."""
    q, k, v = make_qkv(h=1, s=1024, seed=4)
    kw = dict(block_q=128, block_k=128)
    ref = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                                impl="pallas", **kw)
    out = tattn.flash_attention(t(q), t(k), t(v), causal=True, impl="auto", **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=OUT_ATOL)
    for a, b in zip(_grads_torch(q, k, v, True, "auto", **kw),
                    _grads_jax(q, k, v, True, "pallas", **kw)):
        np.testing.assert_allclose(a, np.asarray(b), atol=GRAD_ATOL)


def test_uneven_seq_200():
    """s=200 has no divisor >= 128: one 200-row block in JAX; the port
    accepts it likewise (its CUDA tiles mask the ragged edge)."""
    q, k, v = make_qkv(s=200, seed=5)
    ref = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                impl="pallas", block_q=128, block_k=128)
    out = tattn.flash_attention(t(q), t(k), t(v), impl="auto", block_q=128, block_k=128)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=OUT_ATOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hk", [2, 1])
def test_kernel_plain_versions_match_jax_kernels(causal, hk):
    """Each kernel's plain version against the Pallas kernel it replaces,
    called directly: forward (o, lse), dq, and dk/dv, on the same inputs."""
    b, h, s, d = 2, 2, 256, 64
    q, k, v = make_qkv(b=b, h=h, hk=hk, s=s, d=d, seed=6)
    do = (np.random.RandomState(7).randn(b * h, s, d) * 0.3).astype(np.float32)
    sc = 1.0 / math.sqrt(d)
    qf, kf, vf = q.reshape(b * h, s, d), k.reshape(b * hk, s, d), v.reshape(b * hk, s, d)
    jo, jlse = jattn._flash_fwd(jnp.asarray(qf), jnp.asarray(kf), jnp.asarray(vf), causal, sc,
                                128, 128, h, hk)
    kw = dict(causal=causal, sm_scale=sc, h=h, hk=hk)
    to, tlse = tattn.flash_fwd(t(qf), t(kf), t(vf), **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=OUT_ATOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), atol=OUT_ATOL)

    res = (jnp.asarray(qf), jnp.asarray(kf), jnp.asarray(vf), jo, jlse)
    jdq, jdk, jdv = jattn._flash_bwd(causal, sc, 128, 128, h, hk, res, jnp.asarray(do))
    delta = (t(do) * to).sum(dim=-1, keepdim=True)
    tdq = tattn.flash_bwd_dq(t(qf), t(kf), t(vf), t(do), tlse, delta, **kw)
    tdk, tdv = tattn.flash_bwd_dkv(t(qf), t(kf), t(vf), t(do), tlse, delta, **kw)
    for a, b_ in ((tdq, jdq), (tdk, jdk), (tdv, jdv)):
        assert tuple(a.shape) == b_.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), atol=GRAD_ATOL)


def test_bf16_casts_match_jax_kernel():
    """bf16 inputs: the port's plain forward rounds p to V's dtype where the
    Pallas kernel does. Tolerance 2e-2 absolute on outputs of magnitude
    <= 1: one bf16 ulp is 2^-8 relative, and the two sides round p against
    different running maxima."""
    q, k, v = make_qkv(s=128, seed=8)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    ref = jattn.flash_attention(jq, jk, jv, causal=True, impl="pallas", block_q=128,
                                block_k=128)
    tq, tk, tv = (t(x).to(torch.bfloat16) for x in (q, k, v))
    out = tattn.flash_attention(tq, tk, tv, causal=True, impl="auto")
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=2e-2)


@pytest.mark.parametrize("seq", [64, 128, 200, 1000, 1024, 1100, 2048, 4160, 5000])
def test_pick_block_matches_jax(seq):
    for want in (128, 256, 512, 1024):
        assert tattn._pick_block(seq, want) == jattn._pick_block(seq, want)
    assert tattn.default_bwd_blocks(seq) == jattn.default_bwd_blocks(seq)
    assert tattn.default_blocks(seq) == jattn.default_blocks(seq)


def test_pick_block_error_matches_jax():
    """1031 is prime and > 1024: no block divisor >= 128, both raise."""
    q, k, v = make_qkv(h=1, s=1031, d=32, seed=9)
    with pytest.raises(ValueError, match="no block divisor"):
        jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), impl="pallas")
    with pytest.raises(ValueError, match="no block divisor"):
        tattn.flash_attention(t(q), t(k), t(v), impl="auto")


def test_causal_unequal_lengths_raise():
    """The JAX kernel masks causal Sq != Sk top-left aligned, its reference
    bottom-right aligned; the port refuses the case rather than pick one."""
    q, _, _ = make_qkv(s=128, seed=10)
    _, k, v = make_qkv(s=256, seed=11)
    for impl in ("auto", "xla"):
        with pytest.raises(ValueError, match="seq_q == seq_k"):
            tattn.flash_attention(t(q), t(k), t(v), causal=True, impl=impl)
    # non-causal cross attention of unequal lengths is well defined
    out = tattn.flash_attention(t(q), t(k), t(v), causal=False, impl="auto")
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_ref(q, k, v, False)), atol=OUT_ATOL)


def test_reference_attention_matches_jax():
    """reference_attention itself keeps JAX's bottom-right causal mask."""
    q, _, _ = make_qkv(s=64, seed=12)
    _, k, v = make_qkv(s=96, seed=13)
    ref = jattn.reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    out = tattn.reference_attention(t(q), t(k), t(v), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=OUT_ATOL)


def test_pallas_impl_raises_on_cpu_tensor():
    q, k, v = make_qkv(s=128)
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_attention(t(q), t(k), t(v), impl="pallas")
    with pytest.raises(ValueError, match="impl"):
        tattn.flash_attention(t(q), t(k), t(v), impl="triton")


def test_cpu_path_counts_no_launch():
    """A CPU tensor runs the plain versions: no kernel launch is counted."""
    tattn.reset_launch_counts()
    q, k, v = make_qkv(s=128)
    _grads_torch(q, k, v, True, "auto")
    assert [fn.launches for fn in tattn.KERNELS] == [0, 0, 0]
    for fn in tattn.KERNELS:
        assert fn.route_launches == {"tensor_core": 0, "cuda_core": 0}, fn.__name__


def test_fwd_route_by_dtype():
    """bf16 takes the tensor-core forward, f32 the CUDA-core one (a
    tensor-core f32 product is TF32); other dtypes have no kernel."""
    assert tattn.fwd_route(torch.bfloat16) == "tensor_core"
    assert tattn.fwd_route(torch.float32) == "cuda_core"
    with pytest.raises(ValueError, match="unsupported"):
        tattn.fwd_route(torch.float16)


@pytest.mark.parametrize("wrapper", ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"])
def test_kernel_route_by_dtype(wrapper):
    """One rule (``kernel_route``, which ``fwd_route`` is) names the route
    of all three kernels by dtype, and every wrapper counts its launches
    under exactly the routes the rule names."""
    assert tattn.fwd_route is tattn.kernel_route
    routes = {dt: tattn.kernel_route(dt) for dt in tattn._KERNEL_DTYPES}
    assert routes == {torch.bfloat16: "tensor_core", torch.float32: "cuda_core"}
    assert set(getattr(tattn, wrapper).route_launches) == set(routes.values())


# ---------------------------------------------------------------------------
# layers (the half-split RoPE of ops.layers)


def test_rms_norm_matches_jax():
    rng = np.random.RandomState(14)
    x = rng.randn(2, 5, 64).astype(np.float32)
    w = rng.randn(64).astype(np.float32)
    ref = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(tlayers.rms_norm(t(x), t(w)).numpy(), np.asarray(ref),
                               rtol=1e-6, atol=1e-6)
    # bf16 activations with an f32-cast weight, as JAX does
    xb = jnp.asarray(x, jnp.bfloat16)
    ref_b = jlayers.rms_norm(xb, jnp.asarray(w))
    out_b = tlayers.rms_norm(t(x).to(torch.bfloat16), t(w))
    assert out_b.dtype == torch.bfloat16
    np.testing.assert_allclose(out_b.float().numpy(), np.asarray(ref_b, np.float32),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("with_positions", [False, True])
def test_half_split_rope_matches_jax(with_positions):
    rng = np.random.RandomState(15)
    x = rng.randn(2, 3, 16, 64).astype(np.float32)
    jcos, jsin = jlayers.rope_frequencies(64, 128)
    tcos, tsin = tlayers.rope_frequencies(64, 128)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), atol=1e-6)
    pos = rng.randint(0, 128, size=(2, 16)) if with_positions else None
    ref = jlayers.apply_rope(jnp.asarray(x), jcos, jsin,
                             None if pos is None else jnp.asarray(pos))
    out = tlayers.apply_rope(t(x), tcos, tsin, None if pos is None else torch.from_numpy(pos))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


# ---------------------------------------------------------------------------
# the rule a kernel is held to against its plain version


def _causal_like(rows=512, d=64, seed=16):
    """Rows whose size falls as 1/sqrt(row), as a causal output's does."""
    rng = np.random.RandomState(seed)
    scale = 1.0 / np.sqrt(np.arange(1, rows + 1, dtype=np.float32))[:, None]
    return torch.from_numpy((rng.randn(rows, d) * scale).astype(np.float32))


def test_compare_accepts_one_bf16_ulp():
    """A bf16 rounding of the same values (half an ulp each) passes."""
    p = _causal_like()
    r = kernel_check.compare(p.to(torch.bfloat16), p, "bfloat16")
    assert r["ok"] and r["max_scaled_err"] <= 2.0 ** -8 and r["old_rule_ok"]


@pytest.mark.parametrize("dtype,rel", [("bfloat16", 0.2), ("float32", 1e-3)])
def test_compare_fails_errors_on_small_rows(dtype, rel):
    """An error of ``rel`` of each value on the second half of the rows,
    where values are small, fails; the rule it replaced (max error <=
    tol * max |plain|) let both pass."""
    p = _causal_like()
    k = p.clone()
    k[256:] *= 1 + rel
    r = kernel_check.compare(k, p, dtype)
    assert not r["ok"] and r["max_scaled_err"] > rel / 3
    assert r["old_rule_ok"]


def test_compare_grad_rms_bound_is_tighter():
    """Noise of 2^-9 of each value on every element (dS left unrounded)
    is within the forward output's bf16 bound, where p rounds against
    another maximum, but not within the gradients', where both sides
    round the same p and dS."""
    p = _causal_like()
    noise = torch.from_numpy(np.random.RandomState(17).choice([-1.0, 1.0], p.shape)).float()
    k = p * (1 + 2.0 ** -9 * noise)
    assert kernel_check.compare(k, p, "bfloat16", "o")["ok"]
    assert not kernel_check.compare(k, p, "bfloat16", "grad")["ok"]


def test_compare_zero_row_uses_tensor_floor():
    """A row that is zero up to rounding noise (dq of the first causal row)
    is held to the tensor's size, not its own."""
    p = _causal_like()
    p[0] = 1e-8
    k = p.clone()
    k[0] = -1e-8
    assert kernel_check.compare(k, p, "float32")["ok"]


# ---------------------------------------------------------------------------
# the CUDA kernels (need a card; skipped here)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README, PyTorch/CUDA port)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d", tattn.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,hk,s", [(True, 4, 256), (False, 2, 200), (True, 1, 130)])
def test_cuda_kernels_match_plain(cuda_device, dtype, causal, hk, s, d):
    """Each kernel against its plain version on the card, by
    ``kernel_check.compare``: every element within TOL[dtype][kind] of its
    own size and its row's (bf16: about one ulp of rounding of outputs and
    p/dS; f32: summation order). bf16 runs the three tensor-core kernels,
    f32 the CUDA-core ones, at every instantiated head_dim, with ragged S
    and GQA."""
    readings = kernel_check.parity_case(
        tattn, dict(b=2, h=4, hk=hk, s=s, d=d, dtype=dtype, causal=causal))
    for what, r in readings.items():
        assert r["ok"], (what, r)


@pytest.mark.cuda
def test_cuda_autograd_counts_launches(cuda_device):
    tattn.reset_launch_counts()
    q = torch.randn(1, 2, 128, 32, device=cuda_device, requires_grad=True)
    tattn.flash_attention(q, q, q, causal=True, impl="pallas").sum().backward()
    assert [fn.launches for fn in tattn.KERNELS] == [1, 1, 1]
    for fn in tattn.KERNELS:
        assert fn.route_launches == {"tensor_core": 0, "cuda_core": 1}, fn.__name__
    qb = q.detach().to(torch.bfloat16).requires_grad_()
    tattn.flash_attention(qb, qb, qb, causal=True, impl="pallas").sum().backward()
    assert [fn.launches for fn in tattn.KERNELS] == [2, 2, 2]
    for fn in tattn.KERNELS:
        assert fn.route_launches == {"tensor_core": 1, "cuda_core": 1}, fn.__name__


@pytest.mark.cuda
def test_cuda_fwd_refuses_misaligned_bf16(cuda_device):
    """The tensor-core forward copies 16-byte chunks: a bf16 view that
    starts off a 16-byte boundary is refused, not read misaligned."""
    buf = torch.randn(2 * 128 * 64 + 1, device=cuda_device).to(torch.bfloat16)
    q = buf[1:].view(2, 128, 64)
    with pytest.raises(ValueError, match="16-byte"):
        tattn.flash_fwd(q, q, q, causal=True, sm_scale=0.125, h=2, hk=2)


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", ["flash_bwd_dq", "flash_bwd_dkv"])
def test_cuda_bwd_refuses_misaligned_bf16(cuda_device, wrapper):
    """The tensor-core backward kernels copy 16-byte chunks of q, k, v and
    dO: a bf16 view of any of them that starts off a 16-byte boundary is
    refused, not read misaligned."""
    buf = torch.randn(2 * 128 * 64 + 1, device=cuda_device).to(torch.bfloat16)
    bad = buf[1:].view(2, 128, 64)
    ok = torch.randn(2, 128, 64, device=cuda_device).to(torch.bfloat16)
    rows = torch.zeros(2, 128, 1, device=cuda_device)
    for i in range(4):
        args = [ok] * 4
        args[i] = bad
        with pytest.raises(ValueError, match="16-byte"):
            getattr(tattn, wrapper)(*args, rows, rows, causal=True, sm_scale=0.125, h=2, hk=2)


def test_kernel_build_names_library_by_source_hash(tmp_path, monkeypatch):
    """The build orchestration (one compiler per source, link, hash-named
    library, cached rebuild, reported failure), driven with a stand-in
    compiler since nvcc exists only on the card's machine."""
    from ray_tpu_torch.ops import _build

    fake = tmp_path / "cuda" / "bin" / "nvcc"
    fake.parent.mkdir(parents=True)
    fake.write_text(
        "#!/bin/sh\n"
        'if [ -n "$FAKE_NVCC_FAIL" ]; then echo "error: $FAKE_NVCC_FAIL"; exit 1; fi\n'
        'while [ $# -gt 0 ]; do if [ "$1" = "-o" ]; then echo obj > "$2"; fi; shift; done\n'
        "echo 'ptxas info    : Used 42 registers'\n"
    )
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")

    path, report = _build.build()
    assert path.name == f"libray_tpu_torch_kernels_{_build._digest()}.so" and path.exists()
    n_sources = len(list(_build.CSRC.glob("*.cu")))
    assert not report["cached"] and report["ptxas"].count("Used 42 registers") == n_sources
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == sorted(
        [path.name, path.with_suffix(".log").name])  # objects removed
    again_path, again = _build.build()
    assert again_path == path and again["cached"] and again["ptxas"] == report["ptxas"]

    path.unlink()
    monkeypatch.setenv("FAKE_NVCC_FAIL", "bad kernel")
    with pytest.raises(RuntimeError, match="bad kernel"):
        _build.build()
    assert not any(p.suffix == ".o" for p in (tmp_path / "build").iterdir())


def _extern_c_entries() -> dict:
    """``extern "C"`` entry points of ``ops/csrc/*.cu``: name -> ctypes type
    of each parameter, parsed from the sources."""
    import ctypes
    import re

    from ray_tpu_torch.ops import _build

    entries = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        text = src.read_text()
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
            types = []
            for p in params.split(","):
                p = " ".join(p.split())
                types.append(ctypes.c_void_p if "*" in p else
                             ctypes.c_float if p.startswith("float") else
                             ctypes.c_int if p.startswith("int") else p)
            assert name not in entries, f"{name} defined twice"
            entries[name] = types
    return entries


def test_build_signatures_match_extern_c_sources():
    """Every C entry point of the kernel sources has a ``SIGNATURES`` row
    with the same argument types, and every row names an entry point:
    ctypes would otherwise pass a pointer as a 32-bit int, or fail only
    when the library loads on the card."""
    from ray_tpu_torch.ops import _build

    entries = _extern_c_entries()
    assert set(entries) == set(_build.SIGNATURES)
    for name, types in entries.items():
        assert types == _build.SIGNATURES[name], name


@pytest.mark.parametrize("wrapper", ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"])
def test_extern_c_routes_dtypes_as_kernel_route(wrapper):
    """``rtt_<wrapper>`` hands the bf16 code to the tensor-core kernel of
    ``<wrapper>_tc.cu`` and the f32 code to the CUDA-core kernel of
    ``<wrapper>.cu``, refusing any other, as ``kernel_route`` names the
    routes and ``_KERNEL_DTYPES`` the codes (parsed from the sources)."""
    import re

    from ray_tpu_torch.ops import _build

    code = tattn._KERNEL_DTYPES
    src = (_build.CSRC / f"{wrapper}.cu").read_text()
    body = src[src.index(f'extern "C" int rtt_{wrapper}('):]
    body = body[:body.index("\n}\n")]
    bf16 = re.search(r"if \(dtype == (\d)\)\s+return rtt::(\w+)\(", body)
    assert bf16 and int(bf16.group(1)) == code[torch.bfloat16]
    assert tattn.kernel_route(torch.bfloat16) == "tensor_core"
    assert bf16.group(2) == f"{wrapper}_tc"
    tc_src = (_build.CSRC / f"{wrapper}_tc.cu").read_text()
    assert re.search(rf"\nint {wrapper}_tc\(", tc_src)
    assert f"{wrapper}_tc_kernel<D, " in tc_src
    refuse = f"if (dtype != {code[torch.float32]}) return (int)cudaErrorInvalidValue;"
    assert body.index(bf16.group(0)) < body.index(refuse)
    f32 = body[body.index(refuse):]
    assert tattn.kernel_route(torch.float32) == "cuda_core"
    assert "RTT_DISPATCH_D(" in f32 and f"rtt::{wrapper}_kernel<D>" in f32
    assert re.search(rf"template <int D>\n__global__ void __launch_bounds__\(NT\)\n"
                     rf"{wrapper}_kernel\(const float\* __restrict__ q,", src)


def test_kernel_check_mutants_apply_to_sources():
    """Each broken copy of ``kernel_check.MUTANTS`` finds its text exactly
    once in its source (so a source edit cannot silently disarm it before
    anyone reaches a card), changes it, and names only cases that exist."""
    from ray_tpu_torch.ops import _build

    assert {"fwd_tc_drop_diag_tile_late_rows", "fwd_tc_skip_alpha_rescale",
            "fwd_tc_p_unrounded", "dkv_tc_skip_last_q_tile_early_keys",
            "dkv_tc_first_q_head_only", "dkv_tc_ds_unrounded",
            "dq_tc_skip_first_tile_late_rows", "dq_tc_ds_unrounded"} <= set(kernel_check.MUTANTS)
    bf16 = ("main", "gqa", "non_causal", "s1000")
    for name in ("dkv_tc_skip_last_q_tile_early_keys", "dkv_tc_ds_unrounded",
                 "dq_tc_skip_first_tile_late_rows", "dq_tc_ds_unrounded"):
        assert set(bf16) <= set(kernel_check.MUTANTS[name][3]), name
    assert "gqa" in kernel_check.MUTANTS["dkv_tc_first_q_head_only"][3]
    for name in ("dq_skip_first_tile_late_rows", "dkv_skip_last_q_tile_early_keys",
                 "fwd_drop_diag_tile_late_rows"):  # the CUDA-core kernels run f32 only
        assert kernel_check.MUTANTS[name][3] == ("f32", "tiny"), name
    for name, (fname, text, repl, must_fail) in kernel_check.MUTANTS.items():
        assert (_build.CSRC / fname).read_text().count(text) == 1, name
        assert repl != text, name
        for case in must_fail or ():
            assert case in kernel_check.CASES or case == "tiny", (name, case)


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("causal", [True, False])
def test_chip_smoke_backward_pair_bound_is_the_functions(causal):
    """``chip_smoke.py`` holds dq + dk/dv against one SDPA backward call,
    so their line takes the bound of that function: 5 products (S, dP, dV,
    dK, dQ; S and dP once) and q, k, v, dO, lse, delta read once, dq, dk,
    dv written once -- not the two kernels' bounds added (3 + 4 products)."""
    cs = _chip_smoke()
    b, h, hk, s, d = 2, 32, 8, 2048, 128
    pairs = s * (s + 1) // 2 if causal else s * s
    ms, by, flops, nbytes = cs.bound_ms("flash_bwd", b, h, hk, s, d, "bfloat16", causal)
    assert flops == 2 * 5 * b * h * pairs * d
    assert nbytes == 2 * (3 * b * h * s * d + 4 * b * hk * s * d) + 2 * 4 * b * h * s
    assert by == "operations" and ms == pytest.approx(1e3 * flops / cs.PEAK_FLOPS["bfloat16"])
    kernels = [cs.bound_ms(k, b, h, hk, s, d, "bfloat16", causal)
               for k in ("flash_bwd_dq", "flash_bwd_dkv")]
    assert sum(k[2] for k in kernels) == 2 * 7 * b * h * pairs * d
    assert ms < sum(k[0] for k in kernels)


def test_kernel_check_sweep_summary():
    """``kernel_check --seeds`` reports the worst sound gradient reading
    over every (case, seed, gradient) with its margin under the bf16 RMS
    bound, and each dS-unrounded copy's least reading of the gradient it
    breaks, with its factor over the bound."""
    bound = kernel_check.TOL["bfloat16"]["grad"]["rel_rms"]

    def row(variant, case, seed, dq, dk, dv):
        return {"variant": variant, "case": case, "seed": seed,
                "rel_rms_err": {"dq": dq, "dk": dk, "dv": dv}}

    rows = [row("sound", "main", 0, 8e-5, 1.2e-4, 1e-4),
            row("sound", "gqa", 3, 9e-5, 2.2e-4, 1.5e-4),
            row("sound", "gqa", 1, 9e-5, 2.0e-4, 1.5e-4),
            row("dq_tc_ds_unrounded", "main", 0, 2.6e-3, 1e-4, 1e-4),
            row("dq_tc_ds_unrounded", "s1000", 2, 1.9e-3, 1e-4, 1e-4),
            row("dkv_tc_ds_unrounded", "gqa", 5, 8e-5, 2.4e-3, 1e-4)]
    out = kernel_check.sweep_summary(rows)
    worst = out["sound_worst"]
    assert (worst["grad"], worst["case"], worst["seed"]) == ("dk", "gqa", 3)
    assert worst["bound_over_worst"] == pytest.approx(bound / 2.2e-4)
    dq = out["controls_least"]["dq_tc_ds_unrounded"]
    assert (dq["grad"], dq["case"], dq["rel_rms_err"]) == ("dq", "s1000", 1.9e-3)
    dkv = out["controls_least"]["dkv_tc_ds_unrounded"]
    assert dkv["grad"] == "dk" and dkv["least_over_bound"] == pytest.approx(2.4e-3 / bound)
    assert set(kernel_check.SWEEP_CONTROLS) <= set(kernel_check.MUTANTS)
