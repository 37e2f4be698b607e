#!/usr/bin/env python3
"""chip_smoke.py's phase-2 serving run of qwen2-1.5b, timed for several
checkouts of this repository on one card, in turns.

    python3 tools/serve_ab.py ROOT [ROOT ...]

Each ROOT is a checkout (the parent commit unpacked with ``git archive``
into a directory that .gitignore lists, say); give them in the order to run,
e.g. ``build/parent . . build/parent``.  Every ROOT runs in a process of its
own (each builds its own ``repro_torch`` kernels) and serves through that
ROOT's own ``chip_smoke.serve_main_path`` (8 requests at full width, the
same prompts and random weights in every tree) twice, the first run a
warm-up, holding each step to that tree's serving launches (one fused
append and attention a layer, or two appends and one attention); then its
``profile_windows`` traces two prefill and four decode steps.  Prints, per
ROOT, one JSON line with each run's prefill and decode step medians (host
clock) and output tokens/s, and each window's wall and device-busy ms a
step with the device time and kernel count a step of the append and
attention kernels together; then the card's name and power limit.  Needs
a CUDA card.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

from flash_ab import turns     # tools/ is the script's own directory

# the append and attention kernels of either tree, as CUPTI names them
SERVE_KERNELS = ("kv_append_kernel", "paged_attention_kernel",
                 "paged_attention_f32_kernel",
                 "paged_attention_merge_kernel")
RUN_KEYS = ("prefill_step_ms_median", "decode_step_ms_median", "wall_s",
            "output_tokens_per_s", "steps", "launches")


def run_tree(root: Path, turn: int) -> None:
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)          # puts root/src first on sys.path
    import torch
    from repro_torch.configs import get_config
    from repro_torch.convert import cast_params
    from repro_torch.kernels import common
    from repro_torch.models import build_model, init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    common.library()
    cfg = get_config("qwen2-1.5b")
    api = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = cast_params(init_params(api.init_specs(), gen, device="cuda"),
                         cfg)
    if "paged_attention_append_chunk" in common.LAUNCHES:
        per_layer = {"paged_attention_append_chunk": 1}
    else:
        per_layer = {"kv_append_chunk": 2, "paged_attention_chunk": 1}
    runs = []
    for _ in range(2):
        res = cs.serve_main_path(api, params, cfg, per_layer)
        runs.append({k: res[k] for k in RUN_KEYS})
    windows = cs.profile_windows(api, params, cfg,
                                 {"append+attention": SERVE_KERNELS})
    out = {"tree": str(root), "turn": turn, "runs": runs}
    for w, r in windows.items():
        out[w] = {"wall_ms_per_step": r["wall_ms_per_step"],
                  "device_busy_ms_per_step": r["device_busy_ms_per_step"],
                  "idle_share": r["idle_share"],
                  "append_attention_ms_per_step":
                      r["ops_ms_per_step"]["append+attention"],
                  "append_attention_kernels_per_step":
                      r["ops_kernels_per_step"]["append+attention"]}
    print(json.dumps(out), flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        run_tree(Path(sys.argv[2]).resolve(), int(sys.argv[3]))
        return 0
    return turns(__file__, sys.argv[1:], __doc__)


if __name__ == "__main__":
    sys.exit(main())
