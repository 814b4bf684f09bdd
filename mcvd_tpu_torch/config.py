"""Config namespaces (counterpart of `mcvd_tpu/config.py`).

YAML loading waits for the CLI port; this module builds the same nested
`argparse.Namespace` from dicts, and carries the flagship configuration the
main path runs (`__graft_entry__._flagship_config` in the JAX package).
"""

from __future__ import annotations

import argparse


def dict2namespace(d: dict) -> argparse.Namespace:
    ns = argparse.Namespace()
    for key, value in d.items():
        setattr(ns, key, dict2namespace(value) if isinstance(value, dict) else value)
    return ns


def flagship_config(image_size: int = 64, ngf: int = 64, tiny: bool = False):
    """The smmnist_DDPM_big5-scale NCSN++ config: ngf=64, ch_mult [1,2,3,4],
    2 resblocks per level, attention at 32/16/8 px in 64-channel heads,
    100-step DDPM predicting 16 frames in 5-frame blocks on 5 cond frames.
    `tiny=True` gives the 16 px, ngf 16, ch_mult [1,2] test size."""
    if tiny:
        image_size, ngf = 16, 16
        ch_mult = [1, 2]
        attn = [8]
        num_res_blocks = 1
    else:
        ch_mult = [1, 2, 3, 4]
        attn = [8, 16, 32]
        num_res_blocks = 2
    return dict2namespace(
        {
            "data": {
                "channels": 1, "image_size": image_size, "num_frames": 5,
                "num_frames_cond": 5, "num_frames_future": 0,
                "logit_transform": False, "rescaled": True,
                "prob_mask_cond": 0.0, "prob_mask_future": 0.0,
                "prob_mask_sync": False, "dataset": "StochasticMovingMNIST",
                "step_length": 0.1, "random_flip": True, "num_digits": 2,
                "num_workers": 0,
            },
            "model": {
                "arch": "unetmore", "version": "DDPM", "spade": False,
                "cond_emb": False, "time_conditional": True, "dropout": 0.1,
                "sigma_dist": "linear", "sigma_begin": 0.02, "sigma_end": 0.0001,
                "num_classes": 1000, "ngf": ngf, "ch_mult": ch_mult,
                "num_res_blocks": num_res_blocks, "attn_resolutions": attn,
                "n_head_channels": 64 if not tiny else 8, "conditional": True,
                "noise_in_cond": False, "output_all_frames": False,
                "gamma": False, "ema": True, "ema_rate": 0.999,
            },
            "training": {"L1": False, "batch_size": 8, "n_epochs": 1,
                         "n_iters": 10, "snapshot_freq": 1000, "log_freq": 10},
            "sampling": {"ssim": True, "fvd": False, "subsample": 100,
                         "num_frames_pred": 16, "preds_per_test": 1,
                         "clip_before": True, "denoise": True,
                         "max_data_iter": 1, "batch_size": 8,
                         "one_frame_at_a_time": False, "init_prev_t": -1},
            "optim": {"weight_decay": 0.0, "optimizer": "Adam", "lr": 0.0002,
                      "warmup": 1000, "beta1": 0.9, "amsgrad": False,
                      "eps": 1e-8, "grad_clip": 1.0},
        }
    )
