"""The port's flash-attention kernels held against their plain versions.

``compare`` is the rule every check of a kernel uses (``chip_smoke.py``,
the ``cuda``-marked tests): each element's error is measured against its
own size and its row's, not against the largest value of the tensor, so a
kernel that is wrong on the many small rows of a causal output cannot
hide under the few large ones. ``parity_case`` runs the three kernels and
their plain versions on one input set; ``tiny_reference`` runs the tiny
Llama through both and compares each gradient leaf by relative norm.

``python -m ray_tpu_torch.tools.kernel_check`` (on the card) runs the
parity cases and the tiny reference on the kernels as they are, then on
deliberately broken copies of their sources (``MUTANTS``), built into a
temporary directory outside the checkout. It prints one JSON line per
(variant, case) with the readings and the rule's verdict, beside what the
earlier rule (max error <= 2e-2 * max |plain| in bf16) would have said,
and exits non-zero if the sound kernels fail anywhere or a broken copy
passes a case it must fail.
"""

from __future__ import annotations

import contextlib
import json
import math
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

#: Kernel-vs-plain tolerance, per storage dtype and output kind.
#: ``scaled``: max over elements of |kernel - plain| / (|plain| + rms of its
#: row + rms of the tensor / 16); the row term covers elements that cancel
#: to near zero, the tensor term rows that are zero up to rounding (dq of
#: the first causal row). ``rel_rms``: ||kernel - plain|| / ||plain|| over
#: the tensor.
#: bf16 ``o``: the kernel rounds p to 8 bits against its running maximum,
#: the plain version against the row's final one, so many elements differ
#: by part of an ulp (2^-8..2^-7 relative); 2^-6 and 2^-8 leave a factor
#: of 1.6 over the worst sound reading (o: 9.6e-3 scaled, 2.3e-3 rms).
#: bf16 ``grad`` (dq, dk, dv): both sides take the same lse, so p and dS
#: round alike and only a few outputs flip by one ulp at their final
#: rounding (sound: 9.2e-5 rms at most); 2^-12 keeps a factor of 2.6 and
#: fails a kernel that leaves dS unrounded (2.6e-3 on dk).
#: f32: summation order only (TF32 off); sound at most 5.3e-6 scaled and
#: 2.4e-7 rms.
TOL = {
    "bfloat16": {"o": {"scaled": 2.0 ** -6, "rel_rms": 2.0 ** -8},
                 "grad": {"scaled": 2.0 ** -6, "rel_rms": 2.0 ** -12}},
    "float32": {"o": {"scaled": 1e-5, "rel_rms": 1e-6},
                "grad": {"scaled": 1e-5, "rel_rms": 1e-6}},
}
#: the tensor-wide floor of the denominator, as a fraction of rms(plain)
FLOOR = 1.0 / 16
#: lse is f32 in both dtypes, a log-sum of up to S terms: absolute bound
LSE_ATOL = 1e-4
#: the tiny Llama in f32: per-leaf ||grad_kernel - grad_plain|| / ||grad_plain||
#: (and the same for logits, |dloss| / |loss| for the loss). Summation
#: order only; the sound ratios are at most 1.03e-6.
TINY_REL_TOL = 1e-5
#: the rule this file replaces, reported beside the new one
OLD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}

MAIN = dict(b=2, h=32, hk=32, s=2048, d=128, dtype="bfloat16", causal=True)
CASES = {
    "main": MAIN,
    "gqa": dict(MAIN, hk=8),
    "non_causal": dict(MAIN, causal=False),
    "f32": dict(MAIN, dtype="float32"),
    "s1000": dict(MAIN, s=1000),
}

_BF16_CASES = ("main", "gqa", "non_causal", "s1000")
_FWD_BOUND = "if (causal) nkb = min(nkb, (q0 + BM - 1) / BN + 1);"
_FWD_DROP_DIAG = "if (causal) nkb = min(nkb, (q0 + BM - 1) / BN + 1) - (q0 >= sq / 2);"
_TC_PV = ("          mma_bf16_16816(oacc[2 * dp], pa, vb[0], vb[1]);\n"
          "          mma_bf16_16816(oacc[2 * dp + 1], pa, vb[2], vb[3]);\n")
#: name -> (source file, text, replacement, cases it must fail: None = any
#: verdict is reported, nothing is required). The forward's bf16 cases run
#: the tensor-core kernel (flash_fwd_tc.cu), its f32 cases and the tiny
#: Llama the CUDA-core one (flash_fwd.cu).
MUTANTS = {
    # the second half of the q tiles drops its diagonal K tile
    "fwd_drop_diag_tile_late_rows": (
        "flash_fwd.cu", _FWD_BOUND, _FWD_DROP_DIAG, ("f32", "tiny")),
    "fwd_tc_drop_diag_tile_late_rows": (
        "flash_fwd_tc.cu", _FWD_BOUND, _FWD_DROP_DIAG, ("main", "gqa", "s1000")),
    # the accumulator is not rescaled when the running maximum grows
    "fwd_tc_skip_alpha_rescale": (
        "flash_fwd_tc.cu",
        "oacc[j][0] *= alpha[0]; oacc[j][1] *= alpha[0]; oacc[j][2] *= alpha[1]; "
        "oacc[j][3] *= alpha[1];",
        "", _BF16_CASES),
    # p kept to 16 bits before P.V (a bf16 part and a bf16 remainder, two
    # products) instead of rounded to bf16; reported only, as for the f32
    # kernel's fwd_p_unrounded below
    "fwd_tc_p_unrounded": (
        "flash_fwd_tc.cu", _TC_PV,
        "          uint32_t pr[4];\n"
        "          for (int i = 0; i < 4; ++i)\n"
        "            pr[i] = pack_bf16x2(ps[2 * i] - __uint_as_float(pa[i] << 16),\n"
        "                                ps[2 * i + 1] - __uint_as_float(pa[i] & 0xffff0000u));\n"
        + _TC_PV + _TC_PV.replace("pa,", "pr,"),
        None),
    # the second half of the q rows skips the first K tile
    "dq_skip_first_tile_late_rows": (
        "flash_bwd_dq.cu", "for (int kb = 0; kb < nkb; ++kb) {",
        "for (int kb = (q0 >= sq / 2); kb < nkb; ++kb) {",
        ("main", "gqa", "non_causal", "f32", "s1000", "tiny")),
    # the first half of the keys misses the last q tile
    "dkv_skip_last_q_tile_early_keys": (
        "flash_bwd_dkv.cu", "for (int qb = qb0; qb < nqb; ++qb) {",
        "for (int qb = qb0; qb < nqb - (k0 < sk / 2); ++qb) {",
        ("main", "gqa", "non_causal", "f32", "s1000", "tiny")),
    # dS kept in f32 before dS.K (bf16 only; f32 rounds to itself)
    "dq_ds_unrounded": (
        "flash_bwd_dq.cu", "dSs[(ty + 16 * i) * LDP + tx + 16 * j] = round_to<T>(ds);",
        "dSs[(ty + 16 * i) * LDP + tx + 16 * j] = ds;", _BF16_CASES),
    # dS kept in f32 before dS^T.Q
    "dkv_ds_unrounded": (
        "flash_bwd_dkv.cu", "dSt[(ty + 16 * i) * LDP + r] = round_to<T>(ds);",
        "dSt[(ty + 16 * i) * LDP + r] = ds;", _BF16_CASES),
    # p kept in f32 before P.V: its error is the size of the rounding noise
    # the sound forward already shows against its plain version (running
    # vs final maximum), so no rule can require it to fail; reported only
    "fwd_p_unrounded": (
        "flash_fwd.cu", "Ps[(ty + 16 * i) * LDP + tx + 16 * j] = round_to<T>(p);",
        "Ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;", None),
}


def compare(kern: torch.Tensor, plain: torch.Tensor, dtype: str, kind: str = "o") -> dict:
    """Readings of ``kern`` against ``plain`` (last dim = the row) and
    whether they meet ``TOL[dtype][kind]``."""
    k, p = kern.float(), plain.float()
    err = (k - p).abs()
    p_norm = float(p.square().sum().sqrt())
    rms = p_norm / math.sqrt(p.numel())
    denom = (p.abs() + p.square().mean(dim=-1, keepdim=True).sqrt() + FLOOR * rms)
    max_err = float(err.max())
    out = {
        "max_abs_err": max_err,
        "max_scaled_err": float((err / denom.clamp_min(1e-30)).max()),
        "rel_rms_err": float(err.square().sum().sqrt()) / max(p_norm, 1e-30),
        "old_rule_ok": max_err <= OLD_TOL[dtype] * float(p.abs().max()),
    }
    tol = TOL[dtype][kind]
    out["ok"] = (math.isfinite(out["max_scaled_err"]) and math.isfinite(out["rel_rms_err"])
                 and out["max_scaled_err"] <= tol["scaled"] and out["rel_rms_err"] <= tol["rel_rms"])
    return out


def make_inputs(b, h, hk, s, d, dtype, seed=0):
    """q, k, v, dO on the card, standard normal, from ``seed``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)

    def rnd(rows):
        return torch.randn(rows, s, d, generator=g, device="cuda").to(dt)

    return rnd(b * h), rnd(b * hk), rnd(b * hk), rnd(b * h)


def parity_case(A, c: dict) -> dict:
    """The three kernels against their plain versions on one input set.
    The backward kernels take the plain forward's lse and delta, so each
    kernel is held against its plain version on identical inputs."""
    q, k, v, do = make_inputs(c["b"], c["h"], c["hk"], c["s"], c["d"], c["dtype"])
    h, hk, causal = c["h"], c["hk"], c["causal"]
    sc = 1.0 / math.sqrt(c["d"])
    kw = dict(causal=causal, sm_scale=sc, h=h, hk=hk)
    po, plse = A._fwd_plain(q, k, v, causal, sc, h, hk)
    delta = (do.float() * po.float()).sum(dim=-1, keepdim=True)
    ko, klse = A.flash_fwd(q, k, v, **kw)
    out = {"o": compare(ko, po, c["dtype"])}
    del ko
    out["dq"] = compare(A.flash_bwd_dq(q, k, v, do, plse, delta, **kw),
                        A._bwd_dq_plain(q, k, v, do, plse, delta, causal, sc, h, hk),
                        c["dtype"], "grad")
    kdk, kdv = A.flash_bwd_dkv(q, k, v, do, plse, delta, **kw)
    pdk, pdv = A._bwd_dkv_plain(q, k, v, do, plse, delta, causal, sc, h, hk)
    out["dk"] = compare(kdk, pdk, c["dtype"], "grad")
    out["dv"] = compare(kdv, pdv, c["dtype"], "grad")
    lse_err = float((klse - plse).abs().max())
    out["lse"] = {"max_abs_err": lse_err, "tol": LSE_ATOL, "ok": lse_err <= LSE_ATOL}
    torch.cuda.synchronize()
    return out


def tiny_reference(L) -> dict:
    """``LlamaConfig.tiny`` in f32 at seq 128, the same weights through the
    kernels ("pallas") and through the plain attention ("xla"): relative
    errors of logits, loss and every gradient leaf."""
    g = torch.Generator(device="cuda").manual_seed(1)
    cfg = L.LlamaConfig.tiny(max_seq_len=128)
    tokens = torch.randint(0, cfg.vocab_size, (2, 128), generator=g, device="cuda")
    out = {}
    for impl in ("pallas", "xla"):
        c = L.LlamaConfig.tiny(max_seq_len=128, attention_impl=impl)
        model = L.init_params(c, 0)
        logits = L.forward(c, model, tokens)
        loss = L.next_token_loss(c, model, tokens[:, :-1], tokens[:, 1:])
        loss.backward()
        out[impl] = (logits.detach(), loss.detach(),
                     {n: p.grad for n, p in model.named_parameters()})
    (kl, kloss, kg), (pl, ploss, pg) = out["pallas"], out["xla"]

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    ratios = {"logits": rel(kl, pl), "loss": rel(kloss, ploss)}
    ratios.update({f"grad.{n}": rel(kg[n], pg[n]) for n in pg})
    return {
        "shape_ok": tuple(kl.shape) == (2, 128, cfg.vocab_size) and bool(torch.isfinite(kl).all()),
        "rel_err": ratios,
        "max_rel_err": max(ratios.values()),
        "tol": TINY_REL_TOL,
        "ok": all(math.isfinite(r) and r <= TINY_REL_TOL for r in ratios.values()),
    }


def case_ok(readings: dict) -> bool:
    return all(r["ok"] for r in readings.values())


@contextlib.contextmanager
def use_library(lib):
    """Route the wrappers' launches to ``lib`` for the duration."""
    from ray_tpu_torch.ops import _build

    saved = _build.library
    _build.library = lambda: lib
    try:
        yield
    finally:
        _build.library = saved


def variant_library(tmp: Path, name: str, fname: str, text: str, repl: str):
    """Build and load a copy of the kernel sources in which ``text``, found
    exactly once in ``fname``, is replaced by ``repl``."""
    from ray_tpu_torch.ops import _build

    csrc = tmp / name / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    src = (csrc / fname).read_text()
    if src.count(text) != 1:
        raise RuntimeError(f"variant {name}: {text!r} is not once in {fname}")
    (csrc / fname).write_text(src.replace(text, repl))
    path, _ = _build.build(csrc=csrc, build_dir=tmp / name / "build")
    return _build.load(path)


def _run_variant(A, L, variant: str) -> dict:
    verdicts = {}
    for name, c in CASES.items():
        readings = parity_case(A, c)
        verdicts[name] = case_ok(readings)
        print(json.dumps({"variant": variant, "case": name, **c, "ok": verdicts[name],
                          "readings": readings}), flush=True)
        torch.cuda.empty_cache()
    ref = tiny_reference(L)
    verdicts["tiny"] = ref["ok"] and ref["shape_ok"]
    print(json.dumps({"variant": variant, "case": "tiny", **ref}), flush=True)
    return verdicts


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_check: no CUDA device", file=sys.stderr)
        return 2
    from ray_tpu_torch.models import llama as L
    from ray_tpu_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"nvidia_smi": smi, "tol": TOL, "floor": FLOOR,
                      "tiny_rel_tol": TINY_REL_TOL}), flush=True)
    failures = []
    sound = _run_variant(A, L, "sound")
    failures += [f"sound/{c}" for c, ok in sound.items() if not ok]
    with tempfile.TemporaryDirectory() as tmp:
        for name, (*_, must_fail) in MUTANTS.items():
            fname, text, repl, _ = MUTANTS[name]
            with use_library(variant_library(Path(tmp), name, fname, text, repl)):
                verdicts = _run_variant(A, L, name)
            failures += [f"{name}/{c} passed" for c in must_fail or () if verdicts[c]]
    print(json.dumps({"failures": failures}), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
