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

``python -m ray_tpu_torch.tools.kernel_check --seeds N`` runs, in place
of the mutants, the sound kernels and the two dS-unrounded copies
(``SWEEP_CONTROLS``) in every bf16 case at input seeds 0 .. N-1, and
ends with the worst sound gradient reading against the RMS bound and the
least reading of each copy: the bound's margin on both sides, beyond the
one draw the parity cases take.
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
#: round alike and only a few of them, and of the outputs, flip by one ulp
#: (sound: 2.0e-4 rms at most, dk in gqa: the tensor cores' f32 sums of S
#: and dP round toward zero, and move more p and dS across a rounding
#: boundary than the CUDA cores' did, 9.2e-5); 2^-12 keeps a factor of
#: 1.2 and fails a kernel that leaves dS unrounded (2.6e-3 on dk and dq).
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
_DKV_TC_DK = ("        mma_bf16_16816(tk[0], da, b[0], b[1]);\n"
              "        mma_bf16_16816(tk[1], da, b[2], b[3]);\n")
_DQ_TC_DQ = ("        mma_bf16_16816(acc[2 * dp], pa, b[0], b[1]);\n"
             "        mma_bf16_16816(acc[2 * dp + 1], pa, b[2], b[3]);\n")


def _remainder_products(products: str, packed: str, rest: str, values: str) -> str:
    """``products`` (two mma lines taking the packed bf16 A fragment
    ``packed``) run a second time on ``rest``: the remainder of the f32
    ``values`` after their bf16 rounding, so the sum sees each value to
    16 bits instead of 8."""
    indent = products[:len(products) - len(products.lstrip())]
    return (f"{indent}uint32_t {rest}[4];\n"
            f"{indent}for (int i = 0; i < 4; ++i)\n"
            f"{indent}  {rest}[i] = pack_bf16x2("
            f"{values}[2 * i] - __uint_as_float({packed}[i] << 16),\n"
            f"{indent}      {values}[2 * i + 1] - __uint_as_float({packed}[i] & 0xffff0000u));\n"
            + products + products.replace(f", {packed},", f", {rest},"))


#: name -> (source file, text, replacement, cases it must fail: None = any
#: verdict is reported, nothing is required). Every kernel's bf16 cases run
#: its tensor-core version (``*_tc.cu``), its f32 cases and the tiny Llama
#: the CUDA-core one.
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
    # products) instead of rounded to bf16: its error is the size of the
    # rounding noise the sound forward already shows against its plain
    # version (running vs final maximum), so no rule can require it to
    # fail; reported only
    "fwd_tc_p_unrounded": (
        "flash_fwd_tc.cu", _TC_PV, _remainder_products(_TC_PV, "pa", "pr", "ps"), None),
    # the second half of the q rows skips the first K tile
    "dq_skip_first_tile_late_rows": (
        "flash_bwd_dq.cu", "for (int kb = 0; kb < nkb; ++kb) {",
        "for (int kb = (q0 >= sq / 2); kb < nkb; ++kb) {", ("f32", "tiny")),
    "dq_tc_skip_first_tile_late_rows": (
        "flash_bwd_dq_tc.cu", "if (ks0 >= sk || (causal && ks0 > qw0 + 15)) continue;",
        "if (ks0 >= sk || (causal && ks0 > qw0 + 15) || (k0 == 0 && q0 >= sq / 2)) continue;",
        _BF16_CASES),
    # dS carried to 16 bits (a bf16 part and a bf16 remainder, two products)
    # instead of rounded to bf16 before dS.K
    "dq_tc_ds_unrounded": (
        "flash_bwd_dq_tc.cu", _DQ_TC_DQ, _remainder_products(_DQ_TC_DQ, "pa", "pr", "dsf"),
        _BF16_CASES),
    # the first half of the keys misses the last q tile
    "dkv_skip_last_q_tile_early_keys": (
        "flash_bwd_dkv.cu", "for (int qb = qb0; qb < nqb; ++qb) {",
        "for (int qb = qb0; qb < nqb - (k0 < sk / 2); ++qb) {", ("f32", "tiny")),
    "dkv_tc_skip_last_q_tile_early_keys": (
        "flash_bwd_dkv_tc.cu", "const int nq = max((sq + BQ - 1) / BQ - qb0, 0);",
        "const int nq = max((sq + BQ - 1) / BQ - qb0 - (k0 < sk / 2), 0);", _BF16_CASES),
    # only the group's first q head reaches dk and dv
    "dkv_tc_first_q_head_only": (
        "flash_bwd_dkv_tc.cu", "const int n_it = group * nq;", "const int n_it = nq;",
        ("gqa",)),
    # dS carried to 16 bits before dS^T.Q, as dq_tc_ds_unrounded
    "dkv_tc_ds_unrounded": (
        "flash_bwd_dkv_tc.cu", _DKV_TC_DK, _remainder_products(_DKV_TC_DK, "da", "dr", "dsf"),
        _BF16_CASES),
}
#: the copies ``--seeds`` runs beside the sound kernels: each leaves dS
#: unrounded in one backward kernel, the error the gradient RMS bound exists
#: to catch
SWEEP_CONTROLS = ("dq_tc_ds_unrounded", "dkv_tc_ds_unrounded")


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


def parity_case(A, c: dict, seed: int = 0) -> dict:
    """The three kernels against their plain versions on one input set,
    drawn from ``seed``. The backward kernels take the plain forward's lse
    and delta, so each kernel is held against its plain version on
    identical inputs."""
    q, k, v, do = make_inputs(c["b"], c["h"], c["hk"], c["s"], c["d"], c["dtype"], seed)
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


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls after ``warmup``,
    by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def sweep_summary(rows: list) -> dict:
    """From ``seed_sweep``'s rows: the worst sound gradient reading and its
    margin under the bf16 gradient RMS bound, and each control's least
    reading of the gradient it breaks (dq, or dk) and its factor over it."""
    bound = TOL["bfloat16"]["grad"]["rel_rms"]
    sound = max(((r["rel_rms_err"][w], r["case"], r["seed"], w)
                 for r in rows if r["variant"] == "sound" for w in r["rel_rms_err"]),
                default=None)
    out = {"bound": bound, "sound_worst": None, "controls_least": {}}
    if sound is not None:
        err, case, seed, w = sound
        out["sound_worst"] = {"rel_rms_err": err, "grad": w, "case": case, "seed": seed,
                              "bound_over_worst": bound / max(err, 1e-30)}
    for name in SWEEP_CONTROLS:
        w = "dq" if name.startswith("dq_") else "dk"
        least = min(((r["rel_rms_err"][w], r["case"], r["seed"])
                     for r in rows if r["variant"] == name), default=None)
        if least is not None:
            out["controls_least"][name] = {"rel_rms_err": least[0], "grad": w, "case": least[1],
                                           "seed": least[2], "least_over_bound": least[0] / bound}
    return out


def seed_sweep(A, seeds: int) -> list:
    """Gradient readings (dq, dk, dv) of the sound kernels and of the
    ``SWEEP_CONTROLS`` copies in every bf16 case at input seeds
    ``0 .. seeds - 1``, one JSON line each: how far the sound kernels stay
    under the RMS bound, and the controls over it, beyond one draw."""
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"sound": None}
        libs.update({n: variant_library(Path(tmp), n, *MUTANTS[n][:3]) for n in SWEEP_CONTROLS})
        for variant, lib in libs.items():
            with use_library(lib) if lib is not None else contextlib.nullcontext():
                for case in _BF16_CASES:
                    for seed in range(seeds):
                        r = parity_case(A, CASES[case], seed)
                        row = {"variant": variant, "case": case, "seed": seed,
                               "ok": all(r[w]["ok"] for w in ("dq", "dk", "dv")),
                               "rel_rms_err": {w: r[w]["rel_rms_err"] for w in ("dq", "dk", "dv")},
                               "max_scaled_err": {w: r[w]["max_scaled_err"]
                                                  for w in ("dq", "dk", "dv")}}
                        print(json.dumps(row), flush=True)
                        rows.append(row)
                        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, default=0,
                        help="instead of the mutants, run the sound kernels and the dS-unrounded "
                             "copies at this many input seeds in every bf16 case")
    args = parser.parse_args(argv)
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
    if args.seeds:
        rows = seed_sweep(A, args.seeds)
        summary = sweep_summary(rows)
        failures = [f"{r['variant']}/{r['case']}/seed{r['seed']} "
                    + ("failed" if r["variant"] == "sound" else "passed")
                    for r in rows if r["ok"] == (r["variant"] != "sound")]
        print(json.dumps({"sweep": summary, "failures": failures}), flush=True)
        return 1 if failures else 0
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
