"""The tensor-core forward at 4 and at 8 warps per block, on the card.

``python -m ray_tpu_torch.tools.fwd_tc_warps`` builds the kernel sources
once for each warp count (``TC_WARPS`` in ``ops/csrc/flash_fwd_tc.cu``: 16
query rows per warp, so 64 or 128 rows per block) into a temporary
directory. For each it checks the forward against its plain version at
``kernel_check.MAIN`` by ``kernel_check.compare``, then times it with CUDA
events in turns (4, 8, 8, 4 warps), 20 launches per turn after a warm-up.
It prints one JSON line per warp count, and the card's name and power
limit.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from ray_tpu_torch.tools import kernel_check as K

WARPS = (4, 8)
_DECL = re.compile(r"constexpr int TC_WARPS = \d+;")


def main() -> int:
    if not torch.cuda.is_available():
        print("fwd_tc_warps: no CUDA device", file=sys.stderr)
        return 2
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import attention as A

    c = K.MAIN
    q, k, v, _ = K.make_inputs(c["b"], c["h"], c["hk"], c["s"], c["d"], c["dtype"])
    sc = 1.0 / math.sqrt(c["d"])
    kw = dict(causal=c["causal"], sm_scale=sc, h=c["h"], hk=c["hk"])
    plain, _ = A._fwd_plain(q, k, v, c["causal"], sc, c["h"], c["hk"])
    decl = _DECL.search((_build.CSRC / "flash_fwd_tc.cu").read_text()).group(0)
    times = {w: [] for w in WARPS}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {w: K.variant_library(Path(tmp), f"warps{w}", "flash_fwd_tc.cu", decl,
                                     f"constexpr int TC_WARPS = {w};") for w in WARPS}
        readings = {}
        for w in WARPS:
            with K.use_library(libs[w]):
                readings[w] = K.compare(A.flash_fwd(q, k, v, **kw)[0], plain, c["dtype"])
        for w in (*WARPS, *reversed(WARPS)):
            with K.use_library(libs[w]):
                times[w].append(K.time_ms(lambda: A.flash_fwd(q, k, v, **kw)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    for w in WARPS:
        print(json.dumps({"warps": w, "rows_per_block": 16 * w, "shape": c, "ms": times[w],
                          "parity": readings[w], "nvidia_smi": smi}), flush=True)
    return 0 if all(r["ok"] for r in readings.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
