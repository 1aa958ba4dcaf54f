"""Multi-process PIE-Bench sweep launcher.

Counterpart of the JAX package's ``tools/launch_distributed_sweep.py``, with
its flags. Run the same command once per process (one process per card, on
one host or several); each joins the process group
(``parallel/mesh.py initialize_distributed``), takes its shard of the
700-image list (strided by rank, balancing categories), and sweeps it
(``eval/sweep.py run_sweep``). Outputs land in a shared ``--exp_path``;
resume-by-output makes relaunches idempotent.

    # on every host, once per card (process ids 0..N-1):
    python -m image_editing_framework_torch.tools.launch_distributed_sweep --method p2p \\
        --dataset_path /data/PIE --exp_path /shared/test_exp \\
        --coordinator host0:8476 --num_processes 4 --process_id $ID

A process runs on card ``process_id % device_count`` of its host over NCCL,
or with ``--device cpu`` on the CPU over gloo. ``--coordinator`` is
``host:port`` or a URL (``tcp://...``, ``file:///shared/path``).
``--shard_index`` / ``--shard_count`` instead name the shard by hand, for
processes that share only ``--exp_path``.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("distributed PIE-Bench sweep")
    p.add_argument("--method", type=str, default="p2p")
    p.add_argument("--sd_version", type=str, default="1.5")
    p.add_argument("--dataset_path", type=str, required=True)
    p.add_argument("--exp_path", type=str, required=True)
    p.add_argument("--inversion_type", type=str, default="ddim")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--num_steps", type=int, default=50)
    p.add_argument("--max_items", type=int, default=None)
    p.add_argument("--resolution", type=int, default=None)
    p.add_argument("--random_weights", action="store_true",
                   help="production-shape pipeline with deterministic random weights (identical compute cost; the "
                        "sweep's rehearsal when no checkpoints exist)")
    # the process group (omit all three for one process)
    p.add_argument("--coordinator", type=str, default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    # explicit shard override: processes without a process group (independent
    # hosts sharing only --exp_path) each name their own slice of the list
    p.add_argument("--shard_index", type=int, default=None)
    p.add_argument("--shard_count", type=int, default=None)
    p.add_argument("--save_inversions", type=str, default=None,
                   help="directory to write per-image inversion artifacts (latent + NTI uncond_seq)")
    p.add_argument("--inversion_path", type=str, default=None,
                   help="consume precomputed inversions from this cache instead of inverting")
    p.add_argument("--no-metrics", dest="no_metrics", action="store_true",
                   help="skip per-image quality metrics (pure-throughput runs)")
    p.add_argument("--tiny", action="store_true", help="tiny_pipeline instead of production shapes (f32)")
    p.add_argument("--device", type=str, default="cuda", help="'cuda' (this process's card) or 'cpu'")
    args = p.parse_args(argv)
    if args.shard_index is not None and (not args.shard_count or args.shard_count <= args.shard_index):
        # shard_index without a larger shard_count would have every shard
        # sweep overlapping near-full lists instead of a partition. Refuse.
        raise SystemExit("--shard_index requires --shard_count > shard_index "
                         f"(got index={args.shard_index} count={args.shard_count})")

    import torch
    import torch.distributed as dist

    from image_editing_framework_torch.eval.sweep import run_sweep
    from image_editing_framework_torch.parallel.mesh import initialize_distributed

    cpu = args.device == "cpu"
    proc = initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                                  backend="gloo" if cpu else "nccl")
    count = args.num_processes or 1
    device = torch.device("cpu") if cpu else torch.device("cuda", proc % max(torch.cuda.device_count(), 1))
    try:
        if args.tiny:
            from image_editing_framework_torch.pipelines import tiny_pipeline

            pipe = tiny_pipeline(num_steps=args.num_steps, device=device)
        elif args.random_weights:
            from image_editing_framework_torch.pipelines import random_pipeline

            pipe = random_pipeline(args.sd_version, args.num_steps, dtype=torch.bfloat16, device=device)
        else:
            from image_editing_framework_torch.models.registry import load_pipeline

            pipe = load_pipeline(args.sd_version, args.num_steps, dtype=torch.bfloat16, device=device)
        if args.shard_index is not None:
            proc, count = args.shard_index, args.shard_count
        stats = run_sweep(
            pipe, args.method, args.dataset_path, args.exp_path, inversion_type=args.inversion_type, seed=args.seed,
            shard_index=proc, shard_count=count, batch_size=args.batch_size, max_items=args.max_items,
            resolution=args.resolution, save_inversions=args.save_inversions, inversion_path=args.inversion_path,
            record_metrics=not args.no_metrics,
        )
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"[process {proc}/{count}] {stats}")
    return stats


if __name__ == "__main__":
    main()
