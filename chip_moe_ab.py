"""Times the Mixtral decode step of one checkout of this repository on one
NVIDIA GPU: ``chip_smoke.py``'s phase 5m(a) row serving.

    python3 chip_moe_ab.py <checkout>

It imports ``neuronx_distributed_tpu_torch`` from ``<checkout>`` (so the
kernels built and the model run are that checkout's) and the serving
helpers of the ``chip_smoke.py`` beside this script, so two checkouts meet
the same inputs and the same timing. It builds the checkout's kernels
first, makes ``mixtral_8x7b`` cut to 16 layers (every width kept, random
bf16 weights from seed 0), serves ``chip_smoke.serve``'s six requests
through a row engine at 8 slots (the decode step captured once and
replayed), then the same requests once more under the profiler. It prints
one JSON line: the card, ms a decode-only step (host wall), decode tokens/s
(chunk wall), TTFT mean, the device's idle share, and the profiled run's
device ms by kernel family (prefills and decode steps) with its executed
decode steps. To compare two checkouts on one card, run them back
to back as old, new, new, old.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys


def main() -> int:
    tree = os.path.abspath(sys.argv[-1])
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("chip_moe_ab: no CUDA device is available", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from neuronx_distributed_tpu_torch.kernels import _build
    from neuronx_distributed_tpu_torch.models.mixtral import (
        MixtralForCausalLM,
        init_params,
        mixtral_8x7b,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    _build.build(["flash_attention", "flash_decode", "dequantize", "moe_experts"])
    model = init_params(MixtralForCausalLM(mixtral_8x7b(num_layers=cs.MOE_LAYERS_BF16)), seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    srv = cs.serve(model, gen)
    prof = cs.profile_serving(model, srv["workload"])
    snap = srv["snap"]
    busy = sum(prof["fams"].values())
    wall_ms = 1e3 * (srv["wall_s"] - snap["capture_s"])
    print(json.dumps(dict(
        tree=tree, card=card, layers=model.config.num_layers,
        step_ms=1e3 * srv["decode_s"] / max(srv["decode_only_executed"], 1),
        tokens_per_s=snap["chunk_tokens_per_sec"], ttft_mean_s=snap["mean_ttft"],
        idle_share=1 - busy / wall_ms, device_ms=prof["fams"], executed=prof["executed"],
        per_replay=srv["per_replay"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
