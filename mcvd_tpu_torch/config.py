"""Config namespaces (counterpart of `mcvd_tpu/config.py`).

YAML loading waits for the CLI port; this module builds the same nested
`argparse.Namespace` from dicts, and carries the flagship configuration the
main path runs (`__graft_entry__._flagship_config` in the JAX package) and
copies of two shipped configs whose attention heads are not 64 wide
(`configs/bair_big.yml`, D=96; `configs/cityscapes_big.yml`, D=128).
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


def _video_big_config(name: str) -> dict:
    """`configs/<name>.yml` as a dict, for the two big video configs the
    port's tests and `chip_smoke.py` build (the card machine has no yaml).
    Both files come from the same generator; they differ in the dataset,
    the image size, the widths and head dims, dropout, and cityscapes'
    `parallel` section and missing `data.test_subset`."""
    city = name == "cityscapes_big"
    data = {"channels": 3, "color_jitter": 0.0, "dataset": "Cityscapes" if city else "BAIR",
            "gaussian_dequantization": False, "image_size": 128 if city else 64,
            "logit_transform": False, "num_digits": 2, "num_frames": 5, "num_frames_cond": 2,
            "num_frames_future": 0, "num_workers": 0, "prob_mask_cond": 0.0,
            "prob_mask_future": 0.0, "prob_mask_sync": False, "random_flip": True,
            "rescaled": True, "step_length": 0.1, "uniform_dequantization": False}
    if not city:
        data["test_subset"] = -1
    width = 128 if city else 96
    d = {
        "data": data,
        "eval": {"i3d_weights": None, "inception_weights": None,
                 "lpips_alexnet_weights": None, "lpips_weights": None},
        "fast_fid": {"batch_size": 1000, "begin_ckpt": 5000, "end_ckpt": 300000,
                     "ensemble": False, "freq": 5000, "n_steps_each": 0, "num_samples": 1000,
                     "pr_nn_k": 3, "step_lr": 0.0, "verbose": False},
        "model": {"arch": "unetmore", "attn_resolutions": [8, 16, 32],
                  "ch_mult": [1, 1, 2, 3, 4] if city else [1, 2, 3, 4], "cond_emb": False,
                  "conditional": True, "depth": "deeper", "dropout": 0.0 if city else 0.1,
                  "ema": True, "ema_rate": 0.999, "gamma": False, "n_head_channels": width,
                  "ngf": width, "noise_in_cond": False, "nonlinearity": "swish",
                  "normalization": "InstanceNorm++", "num_classes": 1000, "num_res_blocks": 2,
                  "output_all_frames": False, "sigma_begin": 0.02, "sigma_dist": "linear",
                  "sigma_end": 0.0001, "spade": False, "spade_dim": 128, "spec_norm": False,
                  "time_conditional": True, "type": "v1", "version": "DDPM"},
        "optim": {"amsgrad": False, "beta1": 0.9, "eps": 1e-08, "grad_clip": 1.0,
                  "lr": 0.0001, "optimizer": "Adam", "warmup": 5000, "weight_decay": 0.0},
        "sampling": {"batch_size": 100, "ckpt_id": 0, "clip_before": True, "consistent": True,
                     "data_init": False, "denoise": True, "fid": False, "final_only": True,
                     "fvd": True, "init_prev_t": -1.0, "inpainting": False,
                     "interpolation": False, "max_data_iter": 100000, "n_interpolations": 15,
                     "n_steps_each": 0, "num_frames_pred": 28, "num_samples4fid": 10000,
                     "num_samples4fvd": 10000, "one_frame_at_a_time": False,
                     "preds_per_test": 1, "ssim": True, "step_lr": 0.0, "subsample": 100,
                     "train": False},
        "test": {"batch_size": 100, "begin_ckpt": 5000, "end_ckpt": 300000},
        "training": {"L1": False, "batch_size": 64, "checkpoint_freq": 1000,
                     "compute_dtype": "float32", "log_all_sigmas": False, "log_freq": 100,
                     "n_epochs": 1000000, "n_iters": 3000001, "sample_freq": 50000,
                     "snapshot_freq": 50000, "snapshot_sampling": True,
                     "steps_per_dispatch": 1, "val_freq": 1000, "wire_dtype": "uint8"},
    }
    if city:
        d["parallel"] = {"tensor": 2}
    return d


def bair_big_config():
    """`configs/bair_big.yml`: 64 px BAIR, ngf 96, ch_mult [1,2,3,4],
    attention at 32/16/8 px in 96-channel heads (2, 3 and 4 heads)."""
    return dict2namespace(_video_big_config("bair_big"))


def cityscapes_big_config():
    """`configs/cityscapes_big.yml`: 128 px Cityscapes, ngf 128, ch_mult
    [1,1,2,3,4], attention at 32/16/8 px in 128-channel heads (2, 3 and 4
    heads)."""
    return dict2namespace(_video_big_config("cityscapes_big"))
