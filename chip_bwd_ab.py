"""Times the flash-attention kernels K1 (forward), K2 (dK/dV) and K3 (dQ)
and the training step of one checkout of this repository on one NVIDIA
GPU.

    python3 chip_bwd_ab.py <checkout> [--kernels-only]

It imports ``neuronx_distributed_tpu_torch`` and ``chip_smoke.py`` from
``<checkout>`` (so the kernels built are that checkout's). It times K1 at
the serving prefills (B=1, S=512 with 77 left-padding rows and S=4096 with
1001, as segment -1) and at the training batch (B=2, S=4096, unpacked and
with packed documents), H=32, Hkv=8, D=128, causal: device time of 10 calls
captured in a CUDA graph and replayed, and back to back (CUDA events, the
mean of 20 launches after 3). Then K2 and K3 at B=2, S=4096, unpacked and
with the packed segment ids of ``chip_smoke.check_k2k3`` (back to back),
and, unless ``--kernels-only``, ``chip_smoke.train_phase()``: six steps of
Llama-3-8B width cut to 8 layers, the median step wall, mfu and one
profiled step's device time by kernel. The inputs come from one seed, the
same in every checkout. It prints one JSON line. To compare two checkouts
on one card, run them back to back as old, new, new, old.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def main() -> int:
    tree = os.path.abspath(sys.argv[1])
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_bwd_ab: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from neuronx_distributed_tpu_torch.kernels import flash_attention as tfa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(0)
    h, hkv, d = 32, 8, 128
    kernels = {}
    for name, b, s, segments in (("serving_512", 1, 512, 77), ("serving_4096", 1, 4096, 1001),
                                 ("training_unpacked", 2, 4096, None),
                                 ("training_packed", 2, 4096, "packed")):
        q, k, v = (torch.randn(b, s, n, d, generator=gen, device=dev).to(bf) for n in (h, hkv, hkv))
        seg = None
        if segments == "packed":
            seg = torch.from_numpy(cs.packed_segments(np.random.default_rng(s), b, s)).to(dev)
        elif segments is not None:
            seg = torch.zeros(b, s, dtype=torch.int32, device=dev)
            seg[:, :segments] = -1
        call = lambda: tfa.flash_attention_fwd(q, k, v, True, seg)  # noqa: E731
        kernels[f"k1_{name}_ms"] = cs.graph_ms(call, 10)
        kernels[f"k1_{name}_eager_ms"] = cs.cuda_ms(call, 20, warmup=3)
        del q, k, v, seg
    b, s = 2, 4096
    for packed in (False, True):
        q, k, v, do = (torch.randn(b, s, n, d, generator=gen, device=dev).to(bf) for n in (h, hkv, hkv, h))
        seg = (torch.from_numpy(cs.packed_segments(np.random.default_rng(s), b, s)).to(dev)
               if packed else None)
        out, lse = tfa.flash_attention_fwd(q, k, v, True, seg)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, lse, delta, True, seg)
        tag = "packed" if packed else "unpacked"
        kernels[f"dkdv_{tag}_ms"] = cs.cuda_ms(lambda: tfa.flash_attention_dkdv(*args), 20, warmup=3)
        kernels[f"dq_{tag}_ms"] = cs.cuda_ms(lambda: tfa.flash_attention_dq(*args), 20, warmup=3)
        del q, k, v, do, out, lse, delta, args
    torch.cuda.empty_cache()
    if "--kernels-only" in sys.argv[2:]:
        print(json.dumps(dict(tree=tree, card=card, **kernels)), flush=True)
        return 0
    tr = cs.train_phase()
    print(json.dumps(dict(tree=tree, card=card, **kernels, train_wall_s=tr["wall"],
                          train_walls_s=tr["walls"], mfu=tr["mfu"], device_ms=tr["fams"],
                          launches=tr["launches"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
