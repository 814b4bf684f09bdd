"""Quick sampling from a checkpoint (counterpart of the repository's
`quick_sample.py`; upstream quick_sample.py:41-130): the model and config
beside the checkpoint, the cond of the first test clips, one block sampled,
the arrays saved.

    python -m mcvd_tpu_torch.quick_sample --ckpt_path EXP/logs/checkpoint \\
        --data_path DATA [--out quick_samples.npz] [--subsample 100] \\
        [--batch_size 4] [--seed 0] [--device cuda|cpu]

The npz holds `samples`, `real` and `cond`, folded (B, H, W, F*C) in [0, 1].
"""

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt_path", required=True)
    p.add_argument("--data_path", default="datasets")
    p.add_argument("--out", default="quick_samples.npz")
    p.add_argument("--subsample", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from mcvd_tpu_torch.data import (DataLoader, conditioning_fn, data_transform, get_dataset,
                                     inverse_data_transform)
    from mcvd_tpu_torch.load_model_from_ckpt import get_sampler, init_samples, load_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, params, config, sched = load_model(args.ckpt_path, device=args.device)
    if args.subsample:
        config.sampling.subsample = args.subsample
    config.sampling.batch_size = args.batch_size

    _, test_ds = get_dataset(args.data_path, config, video_frames_pred=config.data.num_frames)
    X, _ = next(iter(DataLoader(test_ds, batch_size=args.batch_size, shuffle=False)))
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    Xt = data_transform(config, torch.from_numpy(X).to(args.device))
    real, cond, cond_mask = conditioning_fn(
        config, Xt, num_frames_pred=config.data.num_frames,
        conditional=config.data.num_frames_cond > 0, generator=gen)
    nhwc = (lambda t: None if t is None else t.permute(0, 2, 3, 1))
    init = init_samples(config, generator=gen, device=args.device)[:len(X)]
    samples = get_sampler(config, model, params, sched)(init, nhwc(cond), cond_mask,
                                                        generator=gen)
    host = (lambda t: None if t is None else t.float().cpu().numpy())
    samples = host(samples)
    np.savez(args.out, samples=samples,
             real=host(inverse_data_transform(config, nhwc(real))),
             cond=host(inverse_data_transform(config, nhwc(cond))) if cond is not None else None)
    print(f"wrote {args.out}: samples {samples.shape}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
