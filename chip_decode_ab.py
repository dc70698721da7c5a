"""Times the decode kernels K4 (row cache) and K5 (paged cache) and the
serving paths of one checkout of this repository on one NVIDIA GPU.

    python3 chip_decode_ab.py <checkout>

It imports ``neuronx_distributed_tpu_torch`` from ``<checkout>`` (so the
kernels built are that checkout's) and the input builders and serving
phases of the ``chip_smoke.py`` beside this script, so two checkouts meet
the same inputs and the same timing. It builds the checkout's kernels
first, so no build falls inside a timed phase. K4 at
``chip_smoke.check_k4``'s shapes and K5 at both of ``check_k5``'s
geometries, each timed two ways: 20 calls captured in one CUDA graph and
replayed (device time, the host taken out) and 50 calls back to back (CUDA
events; the host's issue time where it exceeds the device's). Then
Llama-3-8B (all 32 layers, random bf16 weights from seed 0) serves
``chip_smoke.serve``'s six requests and the paged engine
``chip_smoke.paged_workload``'s fifteen, each once more under the profiler
for device time by kernel family (and, for the paged run, the caching
allocator's device allocations). Where the checkout's engine captures its
decode step in a CUDA graph, the capture's wall is reported apart and taken
out of the wall the idle share is read against, and the profiled runs
capture before the profiler opens. It prints one JSON line: per serving
path, ms per decode-only step, decode tokens/s, TTFT mean and max, and the
idle share. To compare two checkouts on one card, run them back to back as
old, new, new, old.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys


def main() -> int:
    tree = os.path.abspath(sys.argv[1])
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("chip_decode_ab: no CUDA device is available", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from neuronx_distributed_tpu_torch.kernels import _build
    from neuronx_distributed_tpu_torch.kernels import flash_decode as tfd
    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM, init_params, llama3_8b

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    _build.build(["flash_attention", "flash_attention_bwd", "flash_decode"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    times = {}
    q, kc, vc, pos, valid = cs.k4_inputs(gen)
    k4 = lambda: tfd.flash_decode_fwd(q, kc, vc, pos, valid)  # noqa: E731
    times["k4"] = dict(graph_ms=cs.graph_ms(k4, 20), eager_ms=cs.cuda_ms(k4, 50))
    del q, kc, vc, pos, valid
    for shapes in ("k4", "serving"):
        q, kp, vp, bt, pos, valid = cs.k5_inputs(gen, shapes)
        k5 = lambda: tfd.paged_flash_decode_fwd(q, kp, vp, bt, pos, valid, 16)  # noqa: E731
        times[f"k5_{shapes}"] = dict(graph_ms=cs.graph_ms(k5, 20), eager_ms=cs.cuda_ms(k5, 50))
        del q, kp, vp, bt, pos, valid
    torch.cuda.empty_cache()

    model = init_params(LlamaForCausalLM(llama3_8b()), seed=0)
    srv = cs.serve(model, gen)
    prof = cs.profile_serving(model, srv["workload"])
    workload = cs.paged_workload(model.config.vocab_size)
    allocs = torch.cuda.memory_stats().get("num_device_alloc", 0)
    paged = cs.serve_paged(model, workload, "fused")
    allocs = torch.cuda.memory_stats().get("num_device_alloc", 0) - allocs
    paged_prof = cs.serve_paged(model, workload, "fused", profiled=True)
    snap, psnap = srv["snap"], paged["snap"]
    # a capture (once per engine, at the first chunk) is no serving work:
    # the idle share is taken over the wall without it
    capture_s = snap.get("capture_s", 0.0)
    serving = dict(wall_s=srv["wall_s"], capture_s=capture_s, ttft_mean_s=snap["mean_ttft"],
                   ttft_max_s=snap["max_ttft"], decode_tok_s=snap["chunk_tokens_per_sec"],
                   ms_per_decode_step=1e3 * srv["decode_s"] / max(srv["decode_only_executed"], 1),
                   decode_compilations=srv["compilations"], device_ms=prof["fams"],
                   k4_records=prof["records"],
                   idle_share=1 - sum(prof["fams"].values()) / (1e3 * (srv["wall_s"] - capture_s)))
    capture_s = paged["capture_s"]
    paged_serving = dict(
        wall_s=paged["wall_s"], capture_s=capture_s, ttft_mean_s=psnap["mean_ttft"],
        ttft_max_s=psnap["max_ttft"], decode_tok_s=psnap["chunk_tokens_per_sec"],
        ms_per_decode_step=1e3 * paged["decode_s"] / max(paged["decode_executed"], 1),
        decode_compilations=paged["compilations"], device_ms=paged_prof["fams"],
        k5_records=paged_prof["records"],
        idle_share=1 - sum(paged_prof["fams"].values()) / (1e3 * (paged["wall_s"] - capture_s)),
        tokens_equal_profiled_rerun=paged_prof["tokens"] == paged["tokens"],
        device_mallocs=allocs)
    print(json.dumps(dict(tree=tree, card=card, kernels=times, serving=serving,
                          paged_serving=paged_serving)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
