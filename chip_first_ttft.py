"""Times the first request of each prefill bucket on one checkout of this
repository's serving engine on one NVIDIA GPU.

    python3 chip_first_ttft.py <checkout> [--layers N]

It imports ``neuronx_distributed_tpu_torch`` from ``<checkout>`` and builds
a row-cache ``ServingEngine`` over Llama-3-8B at full width (random bf16
weights from seed 0; ``--layers`` cuts the depth, 32 by default) with 8
slots, chunks of 8 and no prefix cache. It captures the decode step
(``prewarm()``) and serves one throwaway request, so that the kernels are
built and loaded before anything is timed. Then, for each prompt length of
``LENGTHS`` (each in a padded bucket of its own), one request whose
prefill is the first of its bucket ("first") and one more of the same
length ("again"), each alone on the engine with 2 new greedy tokens; the
TTFT of each is the engine's own (``first_token_time - submit_time``);
the capture's wall and whether ``torch._dynamo`` was imported are
reported beside them.
Kernel libraries go to this script's ``build/kernels`` whatever the
checkout (their names carry the hash of their sources), so checkouts with
the same kernel sources share one build. It prints the card's name and
power limit and one JSON line. To compare checkouts, run them back to back
in one call as old, new, new, old.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

LENGTHS = (100, 400, 1500, 3000)  # padded buckets 128, 512, 2048 and 4096


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkout")
    ap.add_argument("--layers", type=int, default=32)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_first_ttft: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.checkout))
    from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
    from neuronx_distributed_tpu_torch.kernels import _build
    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM, init_params, llama3_8b
    from neuronx_distributed_tpu_torch.serving.engine import ServingEngine

    _build.BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "kernels")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cfg = llama3_8b(num_layers=args.layers)
    model = init_params(LlamaForCausalLM(cfg, device="cuda"), seed=0)
    engine = ServingEngine(model, num_slots=8, decode_chunk_size=8, prefix_cache=None)
    t0 = time.perf_counter()
    engine.prewarm()
    capture_s = time.perf_counter() - t0
    rng = np.random.RandomState(0)
    gcfg = GenerationConfig(max_new_tokens=2, temperature=0.0)

    def ttft(n: int) -> float:
        prompt = rng.randint(1, cfg.vocab_size, size=n).astype(np.int32)
        torch.cuda.synchronize()
        req = engine.submit(prompt, gcfg, seed=n)
        while req.first_token_time is None:
            engine.step()
        engine.run()
        torch.cuda.synchronize()
        return req.first_token_time - req.submit_time

    t0 = time.perf_counter()
    throwaway = ttft(20)
    warmup_s = time.perf_counter() - t0
    out = {}
    for n in LENGTHS:
        first = ttft(n)
        again = ttft(n)
        out[str(n)] = {"first_s": first, "again_s": again, "first_minus_again_s": first - again}
    print(json.dumps({"checkout": args.checkout, "device": smi, "layers": args.layers,
                      "capture_s": capture_s, "throwaway_ttft_s": throwaway,
                      "throwaway_wall_s": warmup_s, "ttft": out,
                      "ledger": hasattr(engine, "programs"),
                      "dynamo_imported": "torch._dynamo" in sys.modules}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
