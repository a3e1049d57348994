"""Offline SAM image-embedding precompute
(JAX ``cli/generate_img_embeddings.py``, reference scripts/generate_img_embeddings.py).

python -m samcarriestheburden_torch.cli.generate_img_embeddings \\
    --sam_type sam --checkpoint data/sam_vit_h_4b8939.pth
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    p = argparse.ArgumentParser(description="Save SAM image embeddings")
    p.add_argument("--sam_type", choices=["sam", "medsam"], default="sam")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="default: data/sam_vit_h_4b8939.pth | data/medsam_vit_b.pth")
    p.add_argument("--model_type", type=str, default=None,
                   help="default: vit_h for sam, vit_b for medsam")
    p.add_argument("--img_dir", type=str, default="data/img_only_front_all_left")
    p.add_argument("--output", type=str, default=None,
                   help="default: data/graz_<sam_type>_img_embedding.h5")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16")
    p.add_argument("--num_devices", type=int, default=None,
                   help="devices of the run: one card per process, so at most the "
                        "process group's size (more raise)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions); default: the card")
    p.add_argument("--limit", type=int, default=None, help="encode only N images")
    p.add_argument("--resume", action="store_true",
                   help="continue an interrupted run (skip stems already in the h5)")
    p.add_argument("--merge_shards", action="store_true",
                   help="merge <output>.part* files from a multi-process run into <output> "
                        "and exit")
    p.add_argument("--quantize", choices=["int8"], default=None,
                   help="int8 serving mode: one-time weight prequantization + the int8 "
                        "encoder kernels (models/quantize.py)")
    p.add_argument("--unroll_blocks", action="store_true",
                   help="accepted for the JAX CLI's sake; no effect: eager PyTorch runs "
                        "the encoder's layers one by one either way")
    p.add_argument("--loader_threads", type=int, default=None,
                   help="image decode+resize worker threads (default min(8, cpu_count)); "
                        "the loader prefetches one batch ahead")
    from samcarriestheburden_torch.cli.common import (add_multihost_flags, add_profile_flag,
                                                      profiled, setup_backend)
    add_profile_flag(p)
    add_multihost_flags(p)
    args = p.parse_args(argv)

    device = setup_backend(args)
    if args.merge_shards:
        from samcarriestheburden_torch.engine.embeddings import merge_embedding_shards

        out = args.output or f"data/graz_{args.sam_type}_img_embedding.h5"
        merge_embedding_shards(out)
        print(f"merged shards into {out}")
        return
    import torch

    from samcarriestheburden_torch.engine.embeddings import precompute_embeddings
    from samcarriestheburden_torch.models.build import sam_model_registry
    from samcarriestheburden_torch.parallel.distributed import process_count

    # each process encodes whole batches on its own card, so --num_devices
    # is the group's size
    world = process_count()
    if args.num_devices not in (None, world):
        raise ValueError(f"--num_devices {args.num_devices} with {world} process(es): each "
                         "process encodes on its own card; start one per card (torchrun "
                         f"--nproc-per-node {args.num_devices})")

    ckpt = args.checkpoint or {"sam": "data/sam_vit_h_4b8939.pth",
                               "medsam": "data/medsam_vit_b.pth"}[args.sam_type]
    model_type = args.model_type or {"sam": "vit_h", "medsam": "vit_b"}[args.sam_type]
    out = args.output or f"data/graz_{args.sam_type}_img_embedding.h5"

    print(f"Using {args.sam_type} model ({model_type}) from {ckpt} on {device}")
    model = sam_model_registry[model_type](checkpoint=ckpt, device=device)
    files = sorted(Path(args.img_dir).glob("*.png"))
    if args.limit:
        files = files[: args.limit]
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[args.dtype]
    with profiled(args.profile):
        precompute_embeddings(model, files, out, Path(ckpt).name,
                              batch_size=args.batch_size, dtype=dtype,
                              medsam=(args.sam_type == "medsam"), resume=args.resume,
                              quantize=args.quantize,
                              unroll_blocks=args.unroll_blocks,
                              loader_threads=args.loader_threads)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
