"""Counts the profiler's K4 kernel records in ``chip_smoke.py``'s profiled
Medusa rerun (phase 5e), several runs in one process, on one NVIDIA GPU,
at each of a list of margins.

    python3 chip_medusa_profile.py [--runs N] [--tokens T] [--margins 0,0.1]

Run it from the root of the repository. It builds Llama-3-8B at full width
(random bf16 weights from seed 0) with phase 5e's four bf16 Medusa heads
from seed 1 (untrained) and phase 5e's first prompt, runs
``medusa_generate`` once unprofiled (the kernels are built and loaded),
then, for each margin (``chip_smoke.PROFILE_MARGIN_S``: host seconds
between the profile's edges and the first and last replays), ``--runs``
times through ``chip_smoke.medusa_run(profiled=True)``. For each run it
prints the K4 kernel records against 2 x rounds x layers and how many
times the marker kernel that opens the profile was recorded. It prints
the card's name and power limit and, last, one JSON line with every run.
It exits 0 when every run at the phase's own margin is exact.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

import chip_smoke as cs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=12)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--margins", default=f"0,{cs.PROFILE_MARGIN_S}")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_medusa_profile: no CUDA device is available", file=sys.stderr)
        return 1
    from neuronx_distributed_tpu_torch.kernels import _build
    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM, init_params, llama3_8b
    from neuronx_distributed_tpu_torch.models.medusa import MedusaForCausalLM, init_medusa_heads

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.build(["flash_attention", "flash_decode"])
    cfg = llama3_8b()
    model = init_params(LlamaForCausalLM(cfg), seed=0)
    gen = torch.Generator(device="cuda").manual_seed(11)
    prompt = torch.randint(1, cfg.vocab_size, (1, cs.MEDUSA_PROMPT), generator=gen, device="cuda")
    serve = init_medusa_heads(MedusaForCausalLM(cfg, cs.MEDUSA_HEADS, base=model), seed=1)
    cs.medusa_run(serve, prompt, args.tokens)
    phase_margin = cs.PROFILE_MARGIN_S
    want_replay = 2 * cfg.num_layers
    runs = []
    for margin in (float(m) for m in args.margins.split(",")):
        cs.PROFILE_MARGIN_S = margin
        for i in range(args.runs):
            t0 = time.perf_counter()
            r = cs.medusa_run(serve, prompt, args.tokens, profiled=True)
            runs.append(dict(margin=margin, records=r["records"], want=want_replay * r["rounds"],
                             markers=r["markers"]))
            print(f"margin {margin} s, run {i}: K4 records {r['records']} against "
                  f"{want_replay * r['rounds']} (2 x {r['rounds']} rounds x {cfg.num_layers}); "
                  f"marker recorded {r['markers']} time(s) ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
    cs.PROFILE_MARGIN_S = phase_margin
    for margin in sorted({x["margin"] for x in runs}):
        at = [x for x in runs if x["margin"] == margin]
        print(f"margin {margin} s: {sum(x['records'] == x['want'] for x in at)} of {len(at)} runs "
              f"exact, the marker recorded in {sum(x['markers'] == 1 for x in at)} ({smi})",
              flush=True)
    print(json.dumps({"device": smi, "runs": runs}))
    own = [x for x in runs if x["margin"] == phase_margin]
    return 0 if all(x["records"] == x["want"] for x in own) else 1


if __name__ == "__main__":
    sys.exit(main())
