"""The port's command line (counterpart of the repository's `main.py`, whose
flags it takes; upstream main.py:20-70):

    python -m mcvd_tpu_torch.main --config configs/smmnist_DDPM_big5.yml \\
        --exp EXP --train [--resume_training] | --video_gen [--ckpt N] \\
        | --sample [--ckpt N] | --test [--ckpt B --end_ckpt E --freq K] \\
        | --fast_fid [--ckpt B --end_ckpt E --freq K --feats_dir D --no_pr] \\
        [--config_mod section.key=value ...] [--device cuda|cpu]

Config YAML -> nested namespace (the port's own YAML reader), typed
`--config_mod` overrides, the experiment directory with the config and
argument snapshots, and one process on one device: the card unless
`--device cpu` (no card raises). With `MCVD_DIST=1` the process is one rank
of a group (`parallel.dist`: the MCVD_* variables, or torchrun's), on
`cuda:LOCAL_RANK` unless `--device` names a device:

    MCVD_DIST=1 MCVD_COORDINATOR=host:port MCVD_NUM_PROCESSES=P \
        MCVD_PROCESS_ID=r python -m mcvd_tpu_torch.main --config ... --train
    MCVD_DIST=1 torchrun --nproc_per_node P -m mcvd_tpu_torch.main ...

`training.batch_size` is then the global batch. Rank 0 writes the code
snapshot, the config and argument copies and the log file; every rank logs
to its stderr, "rank r" in each line. The group is left at the end, after
an error too, and a rank that fails exits 1. TF32 is off: `compute_dtype: float32` runs
fp32 convolutions and matmuls. The metric networks (FVD's I3D, LPIPS,
fast_fid's Inception) take their weight files from `eval.*` or the default
directories (`mcvd_tpu_torch/eval/weights.py`). At the end the kernels'
launch counts of the run are logged ("kernel launches: {...}").
"""

import argparse
import ast
import json
import logging
import os
import shutil
import sys
import traceback

# The port is imported inside the functions: a process that the training
# loop spawns to draw its curves imports this module as its main, and should
# not import torch for that.

def parse_args_and_config(argv=None):
    from mcvd_tpu_torch.compat import yaml_subset
    from mcvd_tpu_torch.config import apply_config_mods, dict2namespace, validate_config

    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", type=str, required=True, help="Path to the config file")
    parser.add_argument("--data_path", type=str, default="datasets", help="Path to the dataset")
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--exp", type=str, default="exp", help="Experiment directory")
    parser.add_argument("--comment", type=str, default="")
    parser.add_argument("--verbose", type=str, default="info")
    parser.add_argument("--train", action="store_true")
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--sample", action="store_true")
    parser.add_argument("--video_gen", action="store_true")
    parser.add_argument("--fast_fid", action="store_true")
    parser.add_argument("--resume_training", action="store_true")
    parser.add_argument("-i", "--image_folder", type=str, default="images")
    parser.add_argument("-v", "--video_folder", type=str, default="videos")
    parser.add_argument("--ckpt", type=int, default=None,
                        help="Checkpoint # to load from (sample/video_gen/test/fast_fid)")
    parser.add_argument("--end_ckpt", type=int, default=None,
                        help="Checkpoint # to sweep until (test/fast_fid)")
    parser.add_argument("--freq", type=int, default=None,
                        help="Checkpoint sweep frequency (test/fast_fid)")
    parser.add_argument("--start_at", type=int, default=0)
    parser.add_argument("--subsample", type=int, default=None,
                        help="Override config.sampling.subsample")
    parser.add_argument("--final_only", type=ast.literal_eval, default=None,
                        choices=[True, False],
                        help="Save only the final image vs all sampling steps")
    parser.add_argument("--no_ema", action="store_true",
                        help="Don't use the EMA weights for eval")
    parser.add_argument("--fid_num_samples", type=int, default=None,
                        help="Override config.fast_fid.num_samples")
    parser.add_argument("--fid_batch_size", type=int, default=None,
                        help="Override config.fast_fid.batch_size")
    parser.add_argument("--no_pr", action="store_true",
                        help="Skip precision/recall in fast_fid (FID only)")
    parser.add_argument("--pr_nn_k", type=int, default=None,
                        help="Override config.fast_fid.pr_nn_k")
    parser.add_argument("--feats_dir", type=str, default=None,
                        help="Dir with precomputed real Inception features (.npy)")
    parser.add_argument("--stats_dir", type=str, default=None,
                        help="Dir with precomputed FID stats (.npz: mu, sigma)")
    parser.add_argument("--ni", action="store_true", help="No interaction")
    parser.add_argument("--interact", action="store_true", help="(no-op, parity)")
    parser.add_argument("--config_mod", nargs="*", default=[],
                        help="Overrides: section.key=value ...")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default; raises without a card) or cpu")
    args = parser.parse_args(argv)

    config = dict2namespace(yaml_subset.load_file(args.config))
    config = apply_config_mods(config, args.config_mod)
    # flag-level overrides (upstream main.py:129-151)
    if args.subsample is not None:
        config.sampling.subsample = args.subsample
    if args.final_only is not None:
        config.sampling.final_only = args.final_only
    if args.no_ema:
        config.model.ema = False
    if args.fid_num_samples is not None:
        config.fast_fid.num_samples = args.fid_num_samples
    if args.fid_batch_size is not None:
        config.fast_fid.batch_size = args.fid_batch_size
    if args.pr_nn_k is not None:
        config.fast_fid.pr_nn_k = args.pr_nn_k
    config = validate_config(config)

    args.log_path = os.path.join(args.exp, "logs")
    args.image_folder = os.path.join(args.exp, "image_samples", args.image_folder)
    args.video_folder = os.path.join(args.exp, "video_samples", args.video_folder)
    return args, config


def set_up_logging(args, rank: int = 0, world: int = 1, to_file: bool = True) -> None:
    """Every rank logs to its stderr; rank 0 also into <exp>/logs/stdout.txt
    (unless not `to_file`: before a rank knows its rank)."""
    level = getattr(logging, args.verbose.upper(), logging.INFO)
    handlers = [logging.StreamHandler()]
    if rank == 0 and to_file:
        os.makedirs(args.log_path, exist_ok=True)
        handlers.append(logging.FileHandler(os.path.join(args.log_path, "stdout.txt")))
    who = f"rank {rank} - " if world > 1 else ""
    logging.basicConfig(level=level,
                        format=f"%(levelname)s - {who}%(filename)s - %(asctime)s - %(message)s",
                        handlers=handlers, force=True)


def save_run_files(args, config) -> None:
    """The config and the arguments beside the logs (upstream
    main.py:156-160)."""
    from mcvd_tpu_torch.compat import yaml_subset
    from mcvd_tpu_torch.config import save_config

    os.makedirs(args.log_path, exist_ok=True)
    save_config(config, os.path.join(args.log_path, "config.yml"))
    yaml_subset.dump_file({k: v for k, v in vars(args).items()
                           if isinstance(v, (str, int, float, bool, list))},
                          os.path.join(args.log_path, "args.yml"))


def snapshot_code(exp_dir: str) -> str:
    """The port's sources and the configs into <exp>/code/ at the start of a
    training run (upstream copy_scripts, main.py:333-356), so an experiment
    can be reproduced from its own directory."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dst = os.path.join(exp_dir, "code")
    if os.path.isdir(dst):
        shutil.rmtree(dst)
    os.makedirs(dst)
    ignore = shutil.ignore_patterns("__pycache__", "*.pyc", "*.so")
    for name in ("mcvd_tpu_torch", "configs"):
        src = os.path.join(root, name)
        if os.path.isdir(src):
            shutil.copytree(src, os.path.join(dst, name), ignore=ignore)
    return dst


def main(argv=None):
    args, config = parse_args_and_config(argv)

    import torch

    from mcvd_tpu_torch import ops
    from mcvd_tpu_torch.parallel import dist as pdist

    set_up_logging(args, to_file=not pdist.enabled())

    # float32 compute is fp32-class, as in the port's kernels and its card
    # checks: PyTorch would run cuDNN's fp32 convolutions in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    try:
        args.device = str(pdist.init_from_env(args.device))
        if pdist.enabled():
            set_up_logging(args, pdist.rank(), pdist.world())
        logging.info("args: %s", vars(args))
        from mcvd_tpu_torch.runners.runner import Runner

        if pdist.is_main():
            save_run_files(args, config)
            if not (args.video_gen or args.sample or args.test or args.fast_fid):
                logging.info("code snapshot: %s", snapshot_code(args.exp))
        runner = Runner(args, config)
        if args.video_gen:
            runner.video_gen(ckpt=args.ckpt)
        elif args.sample:
            runner.sample(ckpt=args.ckpt)
        elif args.test:
            runner.test(begin_ckpt=args.ckpt, end_ckpt=args.end_ckpt, freq=args.freq)
        elif args.fast_fid:
            runner.fast_fid()
        else:
            runner.train()
    except Exception:
        logging.error(traceback.format_exc())
        return 1
    finally:
        logging.info("kernel launches: %s", json.dumps(ops.LAUNCHES))
        pdist.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
