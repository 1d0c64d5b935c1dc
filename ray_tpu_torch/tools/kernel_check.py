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

After the sound kernels' cases it checks that two calls of each f32
kernel (the forward's o and lse, dq, dk and dv) give the same bits
(``same_bits``) in every f32 case.

``kernel_times`` times each kernel on one case beside the card's bound
(``bound_ms``), its plain version and one PyTorch call for the same
function (``scaled_dot_product_attention``, a yardstick the port never
calls); ``chip_smoke.py`` prints it for bf16, and
``python -m ray_tpu_torch.tools.kernel_check --times`` for f32, with the
f32 bound at split TF32's rate beside the CUDA cores', SDPA's backend
pinned and named, and the kernels' and SDPA's results against f64.

``python -m ray_tpu_torch.tools.kernel_check --seeds N`` runs, in place
of the mutants, the sound kernels and the two dS-unrounded copies
(``SWEEP_CONTROLS``) in every bf16 case at input seeds 0 .. N-1, and
the sound kernels in every f32 case, and ends with the worst sound
gradient reading against the RMS bound, the worst sound forward output
readings against theirs, the least reading of each copy, and the worst
sound f32 readings against the f32 bounds: the bounds' margins on both
sides, beyond the one draw the parity cases take.
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
#: f32: summation order only (TF32 off); sound at most 5.8e-6 scaled and
#: 2.4e-7 rms (the forward, whose online softmax rescales O tile by tile,
#: at 8 input seeds). The f32 backward kernels sum every product in
#: the plain version's order and read 0 against it; the bound is what
#: binds any other order: at S=2048 the plain version's own fma chains
#: carry about 1e-6, so a kernel summing otherwise reads over 1e-6 RMS
#: (dk/dv in GQA when the group is one chain, ``dkv_f32_one_chain``).
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
    "f32_gqa": dict(MAIN, dtype="float32", hk=8),
    "f32_s1000": dict(MAIN, dtype="float32", s=1000),
}

_BF16_CASES = ("main", "gqa", "non_causal", "s1000")
_F32_CASES = ("f32", "f32_gqa", "f32_s1000")
_FWD_BOUND = "if (causal) nkb = min(nkb, (q0 + BM - 1) / BN + 1);"
_FWD_DROP_DIAG = "if (causal) nkb = min(nkb, (q0 + BM - 1) / BN + 1) - (q0 >= sq / 2);"
_FWD_F32_ACTIVE = "if (!causal || k0 <= r0 + 63) {"
_FWD_F32_WAIT = "    mbar_wait(full_bar(s), (kb / STAGES) & 1);\n"
_FWD_F32_RELEASE = "    mbar_arrive(empty_bar(s));  // after P.V, the last product that read the stage\n"
_FWD_F32_RESCALE = "for (int j = 0; j < 8; ++j) acc[i][j] *= al;"
_FWD_TC_WAIT_K = "      mbar_wait(full_k(s), ph);\n"
_FWD_TC_WAIT_V = "      mbar_wait(full_v(s), ph);\n"
_TC_RELEASE = "      mbar_arrive(empty_bar(s));\n"
_TC_WAIT_STAGE = "      mbar_wait(full_bar(s), ph);\n"
_DQ_TC_DQ = ("#pragma unroll\n"
             "      for (int kc = 0; kc < BN / 16; ++kc)\n"
             "        wgmma_rs_m64k16(tile, da[kc], desc_mnmajor<SPAN>(kt + 16 * kc * SPAN, "
             "BN * SPAN), kc > 0);\n")
_F32_RELEASE = "    mbar_arrive(empty_bar(s));  // after the last product that read the stage\n"
_DKV_F32_WAIT = "    mbar_wait(full_bar(s), (it / STAGES) & 1);\n"
_DQ_F32_RELEASE = "    mbar_arrive(empty_bar(s));  // after dS.K, the last product that read the stage\n"
_DQ_F32_WAIT = "    mbar_wait(full_bar(s), (kb / STAGES) & 1);\n"
_DQ_F32_DQ = ("    if (NRG * NCG == 256 || ct < NRG * NCG) mm_pb_f32<D, BN, MI, NRG, LDP>(acc, ps, rg, kt, "
              "cg);")
_DKV_TC_DK = ("#pragma unroll\n"
              "        for (int kc = 0; kc < BQ / 16; ++kc)\n"
              "          wgmma_ss_m64k16<1>(tile, desc_kmajor<128>(ds_tile + 32 * kc),\n"
              "                             desc_mnmajor<SPAN>(qt + 16 * kc * SPAN, BQ * SPAN), "
              "kc > 0);\n"
              "        wgmma_commit();\n"
              "        wgmma_wait<0>();\n")


def _rest(lo: str, hi: str, packed: str) -> tuple:
    """The remainders of the f32 values ``lo``, ``hi`` after their bf16
    rounding ``packed`` (as ``pack_bf16x2(lo, hi)`` packs them)."""
    return (f"{lo} - __uint_as_float({packed} << 16)",
            f"{hi} - __uint_as_float({packed} & 0xffff0000u)")


def _dq_ds_unrounded() -> str:
    """dS.K run a second time on the remainder of dS (f32, in ``sacc``)
    after its bf16 rounding (``da``): dQ sees dS to 16 bits instead of 8."""
    lo, hi = _rest("sacc[8 * kc + 2 * i]", "sacc[8 * kc + 2 * i + 1]", "da[kc][i]")
    return ("      uint32_t dr[BN / 16][4];\n"
            "#pragma unroll\n"
            "      for (int kc = 0; kc < BN / 16; ++kc)\n"
            "#pragma unroll\n"
            "        for (int i = 0; i < 4; ++i)\n"
            f"          dr[kc][i] = pack_bf16x2({lo},\n"
            f"                                  {hi});\n"
            "      fence_regs(dr);\n"
            "      wgmma_fence();\n"
            + _DQ_TC_DQ
            + _DQ_TC_DQ.replace("da[kc]", "dr[kc]").replace("kc > 0);", "1);"))


def _dkv_ds_unrounded() -> str:
    """dS^T.Q run a second time on the remainder of dS^T (f32, in ``dpt``)
    after its bf16 rounding, written over the rounded tile once the first
    product has read it: dK sees dS to 16 bits instead of 8."""
    lo, hi = _rest("dpt[4 * j + 2 * r]", "dpt[4 * j + 2 * r + 1]", "hi")
    return (_DKV_TC_DK
            + "#pragma unroll\n"
            "        for (int j = 0; j < BQ / 8; ++j)\n"
            "#pragma unroll\n"
            "          for (int r = 0; r < 2; ++r) {\n"
            "            const uint32_t hi = pack_bf16x2(dpt[4 * j + 2 * r], dpt[4 * j + 2 * r + 1]);\n"
            "            st_shared_b32(ds_tile + ps_off(j, r),\n"
            f"                          pack_bf16x2({lo}, {hi}));\n"
            "          }\n"
            "        fence_proxy_async();\n"
            "        named_barrier_sync(1 + cons, 128);\n"
            "        wgmma_fence();\n"
            + _DKV_TC_DK.replace("kc > 0);", "1);"))


#: name -> (source file, text, replacement, cases it must fail: None = any
#: verdict is reported, nothing is required); text and replacement are
#: strings, or tuples of strings for a copy made by several edits, each
#: text found exactly once. Every kernel's bf16 cases run its tensor-core
#: version (``*_tc.cu``), its f32 cases and the tiny Llama the CUDA-core
#: one.
MUTANTS = {
    # the second half of the q rows drops its diagonal K tile (f32: a
    # consumer warpgroup whose 64 rows start in the second half skips the
    # products of the tile that starts at its first row)
    "fwd_drop_diag_tile_late_rows": (
        "flash_fwd.cu", _FWD_F32_ACTIVE,
        _FWD_F32_ACTIVE.replace("r0 + 63", "r0 + 63 - (r0 >= sq / 2 ? BN : 0)"), ("f32", "tiny")),
    # a consumer releases its K/V stage as soon as the stage has landed,
    # before S and P.V read it (as fwd_tc_release_before_pv)
    "fwd_f32_release_before_pv": (
        "flash_fwd.cu", (_FWD_F32_RELEASE, _FWD_F32_WAIT),
        ("", _FWD_F32_WAIT + _FWD_F32_RELEASE), _F32_CASES),
    # the accumulator is not rescaled when the running maximum grows
    "fwd_f32_skip_alpha_rescale": (
        "flash_fwd.cu", _FWD_F32_RESCALE, "for (int j = 0; j < 8; ++j) {}", _F32_CASES + ("tiny",)),
    "fwd_tc_drop_diag_tile_late_rows": (
        "flash_fwd_tc.cu", _FWD_BOUND, _FWD_DROP_DIAG, ("main", "gqa", "s1000")),
    # the accumulator is not rescaled when the running maximum grows
    "fwd_tc_skip_alpha_rescale": (
        "flash_fwd_tc.cu",
        "for (int i = 0; i < D / 2; ++i) oacc[i] *= alpha[(i >> 1) & 1];",
        "for (int i = 0; i < D / 2; ++i) {}", _BF16_CASES),
    # a consumer releases its ring stage as soon as the stage's K and V have
    # landed, before the products that read them (the P.V last): the
    # producer's next TMA loads may overwrite them underneath. The release
    # still follows both waits on the stage, so the producer cannot run a
    # phase ahead of a wait and hang the kernel.
    "fwd_tc_release_before_pv": (
        "flash_fwd_tc.cu", (_FWD_TC_WAIT_V, _TC_RELEASE, _FWD_TC_WAIT_K),
        ("", "", _FWD_TC_WAIT_K + _FWD_TC_WAIT_V + _TC_RELEASE), ("main", "gqa", "s1000")),
    # the second half of the q rows leaves the first K tile out of dQ
    "dq_skip_first_tile_late_rows": (
        "flash_bwd_dq.cu", _DQ_F32_DQ,
        _DQ_F32_DQ.replace("if (NRG * NCG == 256 || ct < NRG * NCG)",
                           "if ((NRG * NCG == 256 || ct < NRG * NCG) && (kb > 0 || q0 < sq / 2))"),
        ("f32", "tiny")),
    "dq_tc_skip_first_tile_late_rows": (
        "flash_bwd_dq_tc.cu", "for (int i = 0; i < D / 2; ++i) dq[i] += tile[i];",
        "for (int i = 0; i < D / 2; ++i) dq[i] += kb == 0 && q0 >= sq / 2 ? 0.f : tile[i];",
        _BF16_CASES),
    # dS carried to 16 bits (a bf16 part and a bf16 remainder, two products)
    # instead of rounded to bf16 before dS.K
    "dq_tc_ds_unrounded": (
        "flash_bwd_dq_tc.cu", _DQ_TC_DQ, _dq_ds_unrounded(), _BF16_CASES),
    # a consumer releases its K/V stage as soon as the stage has landed,
    # before S, dP and dS.K read it (as fwd_tc_release_before_pv)
    "dq_tc_release_before_products": (
        "flash_bwd_dq_tc.cu", (_TC_RELEASE, _TC_WAIT_STAGE),
        ("", _TC_WAIT_STAGE + _TC_RELEASE), ("main", "gqa", "s1000")),
    # the first half of the keys misses the last q tile
    "dkv_skip_last_q_tile_early_keys": (
        "flash_bwd_dkv.cu", "const int nq = max((sq + BQ - 1) / BQ - qb0, 0);",
        "const int nq = max((sq + BQ - 1) / BQ - qb0 - (k0 < sk / 2), 0);", ("f32", "tiny")),
    # the f32 GQA sum in one chain over the group's queries, not each q
    # head's sum added in turn as the plain version adds them
    "dkv_f32_one_chain": (
        "flash_bwd_dkv.cu", ("      if (group > 1) {\n", "  if (group > 1 && n_it > 0) {"),
        ("      if (false) {\n", "  if (false) {"), ("f32_gqa",)),
    # a consumer releases its ring stage as soon as the stage has landed,
    # before the products that read it (as the tensor-core release mutants)
    "dkv_f32_release_before_products": (
        "flash_bwd_dkv.cu", (_F32_RELEASE, _DKV_F32_WAIT),
        ("", _DKV_F32_WAIT + _F32_RELEASE), _F32_CASES),
    "dq_f32_release_before_products": (
        "flash_bwd_dq.cu", (_DQ_F32_RELEASE, _DQ_F32_WAIT),
        ("", _DQ_F32_WAIT + _DQ_F32_RELEASE), _F32_CASES),
    "dkv_tc_skip_last_q_tile_early_keys": (
        "flash_bwd_dkv_tc.cu", "const int nq = max((sq + BQ - 1) / BQ - qb0, 0);",
        "const int nq = max((sq + BQ - 1) / BQ - qb0 - (k0 < sk / 2), 0);", _BF16_CASES),
    # only the group's first q head reaches dk and dv
    "dkv_tc_first_q_head_only": (
        "flash_bwd_dkv_tc.cu", "const int n_it = group * nq;", "const int n_it = nq;",
        ("gqa",)),
    # dS carried to 16 bits before dS^T.Q, as dq_tc_ds_unrounded
    "dkv_tc_ds_unrounded": (
        "flash_bwd_dkv_tc.cu", _DKV_TC_DK, _dkv_ds_unrounded(), _BF16_CASES),
    # dV and dK summed in one wgmma accumulator chain over the group's
    # queries, not a fresh accumulator a tile added round-to-nearest: the
    # long chain's error takes GQA's dk and dv over the RMS bound
    "dkv_tc_one_chain": (
        "flash_bwd_dkv_tc.cu",
        ("wgmma_ss_m64k16<1>(tile, desc_kmajor<128>(p_tile + 32 * kc),\n"
         "                             desc_mnmajor<SPAN>(dot + 16 * kc * SPAN, BQ * SPAN), kc > 0);",
         "for (int i = 0; i < D / 2; ++i) dv[i] += tile[i];",
         "wgmma_ss_m64k16<1>(tile, desc_kmajor<128>(ds_tile + 32 * kc),\n"
         "                             desc_mnmajor<SPAN>(qt + 16 * kc * SPAN, BQ * SPAN), kc > 0);",
         "for (int i = 0; i < D / 2; ++i) dk[i] += tile[i];"),
        ("wgmma_ss_m64k16<1>(dv, desc_kmajor<128>(p_tile + 32 * kc),\n"
         "                             desc_mnmajor<SPAN>(dot + 16 * kc * SPAN, BQ * SPAN), 1);",
         "for (int i = 0; i < D / 2; ++i) {}",
         "wgmma_ss_m64k16<1>(dk, desc_kmajor<128>(ds_tile + 32 * kc),\n"
         "                             desc_mnmajor<SPAN>(qt + 16 * kc * SPAN, BQ * SPAN), 1);",
         "for (int i = 0; i < D / 2; ++i) {}"), ("gqa",)),
    # a consumer releases its Q/dO stage (with its lse and delta) as soon as
    # the stage has landed, before the four products read it
    "dkv_tc_release_before_products": (
        "flash_bwd_dkv_tc.cu", (_TC_RELEASE, _TC_WAIT_STAGE),
        ("", _TC_WAIT_STAGE + _TC_RELEASE), ("main", "gqa", "s1000")),
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


def same_bits(A, c: dict, seed: int = 0) -> dict:
    """Whether two calls of each kernel on one input set give the same
    bits (no atomics, no order that depends on the schedule)."""
    q, k, v, do = make_inputs(c["b"], c["h"], c["hk"], c["s"], c["d"], c["dtype"], seed)
    kw = dict(causal=c["causal"], sm_scale=1.0 / math.sqrt(c["d"]), h=c["h"], hk=c["hk"])
    runs = []
    for _ in range(2):
        o, lse = A.flash_fwd(q, k, v, **kw)
        delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
        runs.append((o, lse, A.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
                     *A.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)))
    (o1, l1, dq1, dk1, dv1), (o2, l2, dq2, dk2, dv2) = runs
    return {"flash_fwd": bool(torch.equal(o1, o2) and torch.equal(l1, l2)),
            "flash_bwd_dq": bool(torch.equal(dq1, dq2)),
            "flash_bwd_dkv": bool(torch.equal(dk1, dk2) and torch.equal(dv1, dv2))}


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


def edits(text, repl) -> list:
    """A mutant's (text, replacement) pairs, applied in order: one pair, or
    the pairs of two equally long tuples."""
    if isinstance(text, str):
        return [(text, repl)]
    if len(text) != len(repl):
        raise ValueError("a mutant's texts and replacements differ in number")
    return list(zip(text, repl))


def variant_library(tmp: Path, name: str, fname: str, text, repl):
    """Build and load a copy of the kernel sources in which ``text``, found
    exactly once in ``fname``, is replaced by ``repl`` (each pair of
    ``edits(text, repl)`` in turn)."""
    from ray_tpu_torch.ops import _build

    csrc = tmp / name / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    src = (csrc / fname).read_text()
    for old, new in edits(text, repl):
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} is not once in {fname}")
        src = src.replace(old, new)
    (csrc / fname).write_text(src)
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


#: peak rates of one H100 SXM (NVIDIA data sheet; dense tensor-core bf16,
#: CUDA-core f32, dense tensor-core TF32, HBM3). An f32 product in split
#: TF32 takes three TF32 passes (hi.hi + hi.lo + lo.hi), so that route's
#: f32 rate is PEAK_FLOPS["tf32"] / 3, about 164.9 TFLOP/s
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 494.7e12}
PEAK_BYTES = 3.35e12


def bound_ms(kernel, b, h, hk, s, d, dtype, causal, rate=None) -> tuple:
    """The least time for the same work on this card: matmul FLOPs over the
    dtype's peak (or over ``rate``, FLOP/s) vs bytes (each input read once,
    each output written once) over HBM bandwidth. The score pairs counted
    are the ones the mask keeps. ``flash_bwd`` is the whole backward
    function, as one SDPA backward call computes it: dq, dk and dv from 5
    products (S and dP once each)."""
    pairs = s * (s + 1) // 2 if causal else s * s
    esz = 2 if dtype == "bfloat16" else 4
    q_bytes, kv_bytes, row_bytes = b * h * s * d * esz, b * hk * s * d * esz, b * h * s * 4
    n_matmuls, nbytes = {
        "flash_fwd": (2, q_bytes + 2 * kv_bytes + q_bytes + row_bytes),
        "flash_bwd_dq": (3, 2 * q_bytes + 2 * kv_bytes + 2 * row_bytes + q_bytes),
        "flash_bwd_dkv": (4, 2 * q_bytes + 2 * kv_bytes + 2 * row_bytes + 2 * kv_bytes),
        "flash_bwd": (5, 2 * q_bytes + 2 * kv_bytes + 2 * row_bytes + q_bytes + 2 * kv_bytes),
    }[kernel]
    flops = 2 * n_matmuls * b * h * pairs * d
    t_ops, t_bytes = flops / (rate or PEAK_FLOPS[dtype]), nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", flops, nbytes


def f32_bounds(kernel, c) -> dict:
    """An f32 kernel's bound at both rates: exact f32 on the CUDA cores,
    the rate of the design that runs (``bound_ms``), and split TF32 (three
    tensor-core passes a product), which the f32 rule leaves out (the f32
    kernels must sum in the plain version's order; ``flash_bwd_dkv.cu``)."""
    args = (kernel, c["b"], c["h"], c["hk"], c["s"], c["d"], "float32", c["causal"])
    exact = bound_ms(*args)
    split = bound_ms(*args, rate=PEAK_FLOPS["tf32"] / 3)
    return {"bound_ms": exact[0], "bound_by": exact[1], "flops": exact[2], "bytes": exact[3],
            "bound_ms_split_tf32": split[0]}


def sdpa_backend(q4, k4, v4, causal):
    """The SDPA backend pinned for an f32 call: flash attention refuses
    f32, so the memory-efficient kernel, else the math one. Returns
    (name, backend)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for backend in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
            return backend.name.lower(), backend
        except RuntimeError:
            continue
    raise RuntimeError("no SDPA backend takes f32")


def f64_attention(q, k, v, do, causal, sc, h, hk):
    """o, dq, dk, dv of the same attention in f64 (autograd through the
    plain formula; K/V expanded over the GQA group, so dk and dv sum it)."""
    q64, k64, v64 = (t.double().requires_grad_() for t in (q, k, v))
    bhk, s, d = k.shape
    kx = k64.reshape(bhk // hk, hk, 1, s, d).expand(-1, -1, h // hk, -1, -1).reshape(-1, s, d)
    vx = v64.reshape(bhk // hk, hk, 1, s, d).expand(-1, -1, h // hk, -1, -1).reshape(-1, s, d)
    sc64 = torch.matmul(q64, kx.transpose(-1, -2)) * sc
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        sc64 = sc64.masked_fill(~keep, float("-inf"))
    o = torch.matmul(torch.softmax(sc64, dim=-1), vx)
    dq, dk, dv = torch.autograd.grad(o, (q64, k64, v64), do.double())
    return {"o": o.detach(), "dq": dq, "dk": dk, "dv": dv}


def f64_products(A, q, k, v, do, lse, delta, causal, sc, h, hk):
    """dq, dk, dv of the backward kernels' formula in f64 from the same f32
    inputs (lse and delta included): what the products alone would give
    with no rounding, against which the f32 sums' own error reads."""
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    kx, vx = A._expand_kv(k64, h, hk), A._expand_kv(v64, h, hk)
    s64 = torch.matmul(q64, kx.transpose(-1, -2)) * sc
    if causal:
        keep = torch.ones(s64.shape[-2:], dtype=torch.bool, device=q.device).tril()
        s64 = s64.masked_fill(~keep, float("-inf"))
    p = torch.exp(s64 - lse.double())
    ds = p * (torch.matmul(do64, vx.transpose(-1, -2)) - delta.double()) * sc
    return {"dq": torch.matmul(ds, kx),
            "dk": A._group_sum(torch.matmul(ds.transpose(-1, -2), q64), h, hk),
            "dv": A._group_sum(torch.matmul(p.transpose(-1, -2), do64), h, hk)}


def err_f64(x, ref) -> dict:
    """``x`` against an f64 result: relative RMS and the largest element
    error scaled as ``kernel_check.compare`` scales it, computed in f64."""
    e = (x.double() - ref).abs()
    norm = float(ref.square().sum().sqrt())
    rms = norm / math.sqrt(ref.numel())
    denom = ref.abs() + ref.square().mean(dim=-1, keepdim=True).sqrt() + rms / 16
    return {"rel_rms_err": float(e.square().sum().sqrt()) / max(norm, 1e-300),
            "max_scaled_err": float((e / denom.clamp_min(1e-300)).max())}


def kernel_times(A, c) -> tuple:
    """Each kernel, its plain version and the library yardstick timed on
    the inputs of case ``c``, beside the card's bound; then dq + dk/dv
    together against SDPA's one backward call and the bound of the
    function that call computes. In f32 the SDPA backend is pinned and
    named, each f32 kernel has its bound at both f32 rates, and the
    kernels' and SDPA's results are held to an f64 run on the same
    inputs. Returns (rows to print, each kernel's times)."""
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    f32 = c["dtype"] == "float32"
    h, hk, causal = c["h"], c["hk"], c["causal"]

    def bounds(name):
        if f32:
            return f32_bounds(name, c)
        bms, by, flops, nbytes = bound_ms(name, c["b"], h, hk, c["s"], c["d"], c["dtype"], causal)
        return {"bound_ms": bms, "bound_by": by, "flops": flops, "bytes": nbytes}

    q, k, v, do = make_inputs(c["b"], h, hk, c["s"], c["d"], c["dtype"], seed=2)
    sc = 1.0 / math.sqrt(c["d"])
    kw = dict(causal=causal, sm_scale=sc, h=h, hk=hk)
    o, lse = A.flash_fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    kernel_fns = {
        "flash_fwd": lambda: A.flash_fwd(q, k, v, **kw),
        "flash_bwd_dq": lambda: A.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
        "flash_bwd_dkv": lambda: A.flash_bwd_dkv(q, k, v, do, lse, delta, **kw),
    }
    plain_fns = {
        "flash_fwd": lambda: A._fwd_plain(q, k, v, causal, sc, h, hk),
        "flash_bwd_dq": lambda: A._bwd_dq_plain(q, k, v, do, lse, delta, causal, sc, h, hk),
        "flash_bwd_dkv": lambda: A._bwd_dkv_plain(q, k, v, do, lse, delta, causal, sc, h, hk),
    }
    # the library yardstick: one scaled_dot_product_attention call forward,
    # and its backward (dq, dk, dv together) for both backward kernels
    shape4 = (c["b"], h, c["s"], c["d"])
    q4, k4, v4 = (t.reshape(shape4).detach().requires_grad_() for t in (q, k, v))
    do4 = do.reshape(shape4)
    backend, pinned = sdpa_backend(q4, k4, v4, causal) if f32 else ("auto", None)
    with sdpa_kernel([pinned]) if f32 else contextlib.nullcontext():
        o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
        lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal))
        lib_bwd = time_ms(lambda: torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True))
        lib_grads = torch.autograd.grad(o4, (q4, k4, v4), do4)
    library = {"flash_fwd": lib_fwd, "flash_bwd_dq": lib_bwd, "flash_bwd_dkv": lib_bwd}
    vs_f64 = None
    if f32:  # what precision the kernels' and the library's f32 carry
        ref = f64_attention(q, k, v, do, causal, sc, h, hk)
        kdk, kdv = kernel_fns["flash_bwd_dkv"]()
        ours = {"o": o, "dq": kernel_fns["flash_bwd_dq"](), "dk": kdk, "dv": kdv}
        lib = {"o": o4.detach().reshape(o.shape),
               **{n: g.reshape(ref[n].shape) for n, g in zip(("dq", "dk", "dv"), lib_grads)}}
        vs_f64 = {"kernels": {n: err_f64(ours[n], ref[n]) for n in ref},
                  "library": {n: err_f64(lib[n], ref[n]) for n in ref}}
        del ref, lib
        # the products alone: the kernels' sums against the same formula in
        # f64 on the same f32 inputs, lse and delta included
        ref = f64_products(A, q, k, v, do, lse, delta, causal, sc, h, hk)
        vs_f64["kernel_products"] = {n: err_f64(ours[n], ref[n]) for n in ref}
        del ref, ours
    del o4, lib_grads
    rows, times = [], {}
    for name in kernel_fns:
        kms = time_ms(kernel_fns[name])
        pms = time_ms(plain_fns[name], 5, warmup=1)
        bound = bounds(name)
        times[name] = {"ms": kms, "plain_ms": pms, "bound_ms": bound["bound_ms"],
                       "bound_by": bound["bound_by"], "library_ms": library[name]}
        rows.append({"kernel": name, "shape": c, **bound, **times[name],
                     "tflops": bound["flops"] / kms / 1e9, "ms_over_bound": kms / bound["bound_ms"],
                     "ms_over_library": kms / library[name], "library_backend": backend})
    # like for like: one SDPA backward call computes dq, dk and dv together,
    # so the pair is held to that function's bound
    pair = {k: sum(times[n][k] for n in ("flash_bwd_dq", "flash_bwd_dkv"))
            for k in ("ms", "plain_ms")}
    bound = bounds("flash_bwd")
    rows.append({"kernels": "flash_bwd_dq + flash_bwd_dkv", "shape": c, **pair,
                 **bound, "tflops": bound["flops"] / pair["ms"] / 1e9, "library_ms": lib_bwd,
                 "library_backend": backend, "ms_over_bound": pair["ms"] / bound["bound_ms"],
                 "ms_over_library": pair["ms"] / lib_bwd})
    if vs_f64 is not None:
        rows.append({"part": "f32_vs_f64", "shape": c, "library_backend": backend, **vs_f64})
    return rows, times


def time_trees(A, c: dict, libs: dict) -> list:
    """The forward, dq and dk/dv kernels of each library in ``libs`` (name
    -> loaded library, None for this checkout's) timed on the inputs of
    case ``c`` in turns -- each library, then each again in reverse order --
    so that two source trees compare within one call on one card."""
    q, k, v, do = make_inputs(c["b"], c["h"], c["hk"], c["s"], c["d"], c["dtype"], seed=2)
    kw = dict(causal=c["causal"], sm_scale=1.0 / math.sqrt(c["d"]), h=c["h"], hk=c["hk"])
    o, lse = A.flash_fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    rows = []
    for name in [*libs, *reversed(libs)]:
        with use_library(libs[name]) if libs[name] is not None else contextlib.nullcontext():
            rows.append({"tree": name, "shape": c,
                         "flash_fwd_ms": time_ms(lambda: A.flash_fwd(q, k, v, **kw)),
                         "flash_bwd_dq_ms": time_ms(
                             lambda: A.flash_bwd_dq(q, k, v, do, lse, delta, **kw)),
                         "flash_bwd_dkv_ms": time_ms(
                             lambda: A.flash_bwd_dkv(q, k, v, do, lse, delta, **kw))})
    return rows


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
    margin under the bf16 gradient RMS bound, the worst sound forward
    output readings and their margins under the bf16 ``o`` bounds, each
    control's least reading of the gradient it breaks (dq, or dk) and its
    factor over it, and (``f32``) the worst sound f32 gradient readings
    against the f32 bounds."""
    bound = TOL["bfloat16"]["grad"]["rel_rms"]
    bf16 = [r for r in rows if r["case"] not in _F32_CASES]
    sound = max(((r["rel_rms_err"][w], r["case"], r["seed"], w)
                 for r in bf16 if r["variant"] == "sound" for w in r["rel_rms_err"]),
                default=None)
    out = {"bound": bound, "sound_worst": None, "controls_least": {}, "o_worst": {}}
    if sound is not None:
        err, case, seed, w = sound
        out["sound_worst"] = {"rel_rms_err": err, "grad": w, "case": case, "seed": seed,
                              "bound_over_worst": bound / max(err, 1e-30)}
    for kind, o_bound in TOL["bfloat16"]["o"].items():
        key = f"max_{kind}_err" if kind == "scaled" else f"{kind}_err"
        worst = max(((r["o"][key], r["case"], r["seed"])
                     for r in bf16 if r["variant"] == "sound" and "o" in r), default=None)
        if worst is not None:
            out["o_worst"][key] = {"err": worst[0], "case": worst[1], "seed": worst[2],
                                   "bound": o_bound, "bound_over_worst": o_bound / max(worst[0], 1e-30)}
    f32 = [r for r in rows if r["variant"] == "sound" and r["case"] in _F32_CASES]
    if f32:
        out["f32"] = {}
        for kind, key in (("rel_rms", "rel_rms_err"), ("scaled", "max_scaled_err")):
            err, case, seed, w = max((r[key][w], r["case"], r["seed"], w)
                                     for r in f32 for w in r[key])
            bound = TOL["float32"]["grad"][kind]
            out["f32"][key] = {"err": err, "grad": w, "case": case, "seed": seed, "bound": bound,
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
    """Readings of the sound kernels and of the ``SWEEP_CONTROLS`` copies
    (gradients dq, dk, dv; the forward's ``o`` and ``lse``) in every bf16
    case, and of the sound kernels in every f32 case, at input seeds
    ``0 .. seeds - 1``, one JSON line each: how far the sound kernels stay
    under the bounds, and the controls over the gradient RMS bound, beyond
    one draw."""
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"sound": None}
        libs.update({n: variant_library(Path(tmp), n, *MUTANTS[n][:3]) for n in SWEEP_CONTROLS})
        for variant, lib in libs.items():
            with use_library(lib) if lib is not None else contextlib.nullcontext():
                for case in _BF16_CASES + (_F32_CASES if lib is None else ()):
                    for seed in range(seeds):
                        r = parity_case(A, CASES[case], seed)
                        row = {"variant": variant, "case": case, "seed": seed,
                               "ok": all(r[w]["ok"] for w in ("o", "lse", "dq", "dk", "dv")),
                               "rel_rms_err": {w: r[w]["rel_rms_err"] for w in ("dq", "dk", "dv")},
                               "max_scaled_err": {w: r[w]["max_scaled_err"]
                                                  for w in ("dq", "dk", "dv")},
                               "o": {k: r["o"][k] for k in ("max_scaled_err", "rel_rms_err")},
                               "lse_max_abs_err": r["lse"]["max_abs_err"]}
                        print(json.dumps(row), flush=True)
                        rows.append(row)
                        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, default=0,
                        help="instead of the mutants, run the sound kernels and the dS-unrounded "
                             "copies at this many input seeds in every bf16 case, and the sound "
                             "kernels in every f32 case")
    parser.add_argument("--times", action="store_true",
                        help="instead of the mutants, time the f32 kernels at the main shape "
                             "beside their bounds, their plain versions and SDPA's f32 calls")
    parser.add_argument("--against", default=None, metavar="CSRC",
                        help="with --times: then time the f32 forward, dq and dk/dv kernels of "
                             "this checkout and of the kernel sources in CSRC (another tree's "
                             "ray_tpu_torch/ops/csrc) in turns, MHA and GQA")
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
    if args.times:
        rows, _ = kernel_times(A, dict(MAIN, dtype="float32"))
        if args.against:
            from ray_tpu_torch.ops import _build

            with tempfile.TemporaryDirectory() as tmp:
                against = _build.load(_build.build(csrc=Path(args.against), build_dir=Path(tmp))[0])
                for hk in (MAIN["hk"], 8):
                    rows += time_trees(A, dict(MAIN, dtype="float32", hk=hk),
                                       {"against": against, "this": None})
        for row in rows:
            print(json.dumps({"times": "float32", **row}), flush=True)
        return 0
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
    for case in _F32_CASES:
        bits = same_bits(A, CASES[case])
        print(json.dumps({"variant": "sound", "case": case, "same_bits": bits}), flush=True)
        failures += [f"sound/{case}/{k} differs between two calls" for k, ok in bits.items()
                     if not ok]
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
