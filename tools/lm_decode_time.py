#!/usr/bin/env python3
"""Time the mesh-less LM's decode step on one CUDA GPU, for comparing two
checkouts in one call.

For each architecture named, its serving config (bf16) at full width and
depth, weights drawn from a seed on the card: a prefill of ``--prompt``
tokens into a cache of ``--prompt + --warmup + --steps`` positions, then
``--warmup`` decode steps and ``--steps`` timed ones, each between two
CUDA events after a synchronize (so a step's ms holds its host gaps, as
a server sees them).  The model code is imported from ``--src`` (default:
this checkout's ``src``), so a parent checkout unpacked elsewhere is
timed by the same script::

    python3 tools/lm_decode_time.py --label change
    python3 tools/lm_decode_time.py --src build/parent/src --label parent

It prints the card's name and power limit, then one JSON line per
architecture: the label, the mean, median and minimum step ms.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="change")
    ap.add_argument("--archs", default="mistral-nemo-12b,"
                    "seamless-m4t-large-v2,zamba2-2.7b")
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--warmup", type=int, default=4)
    ap.add_argument("--steps", type=int, default=32)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.model import build_model

    if not torch.cuda.is_available():
        print("lm_decode_time: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip(), flush=True)
    for arch in args.archs.split(","):
        config = get_arch(arch).config.for_serving()
        model = build_model(config, device="cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        tokens = torch.as_tensor(np.random.default_rng(0).integers(
            0, config.vocab_size, (1, args.prompt)), device="cuda")
        batch = {"tokens": tokens}
        if config.frontend == "audio_stub":
            batch["frame_embeds"] = torch.randn(
                1, args.prompt, config.d_model, device="cuda",
                generator=torch.Generator(device="cuda").manual_seed(1))
        cap = args.prompt + args.warmup + args.steps
        times = []
        with torch.inference_mode():
            logits, cache = model.prefill(params, batch, max_len=cap)
            tok = logits[:, -1].argmax(-1, keepdim=True)
            for i in range(args.warmup + args.steps):
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                logits, cache = model.decode_step(params, tok, cache)
                end.record()
                torch.cuda.synchronize()
                tok = logits[:, -1].argmax(-1, keepdim=True)
                if i >= args.warmup:
                    times.append(start.elapsed_time(end))
        print(json.dumps({"label": args.label, "arch": arch,
                          "n_layers": config.n_layers,
                          "prompt": args.prompt, "steps": args.steps,
                          "step_ms_mean": statistics.mean(times),
                          "step_ms_median": statistics.median(times),
                          "step_ms_min": min(times)}), flush=True)
        del model, params, cache, logits
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
