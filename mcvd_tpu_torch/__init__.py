"""mcvd_tpu_torch — the PyTorch/CUDA port of `mcvd_tpu` for NVIDIA Hopper.

The package mirrors `mcvd_tpu`'s layout and names so each module's JAX
counterpart is found by path (`mcvd_tpu/X` -> `mcvd_tpu_torch/X`). It imports
torch and numpy only: never jax, flax or yaml. The hot ops that `mcvd_tpu`
wrote as Pallas TPU kernels are hand-written Hopper kernels here (`ops/`),
each beside a plain PyTorch version that CPU tensors use.

Slices ported so far, with the NCSN++ (`arch: unetmore`, 2D, concat
conditioning) score network: DDPM autoregressive video prediction —
`models.get_model` -> `eval.video_gen.make_block_sampler` ->
`eval.video_gen.autoregressive_predict` — its training step —
`train.create_train_state` -> `train.make_train_step` (transform,
conditioning, DSM loss, gradients through the kernels' backward passes,
clip, optimizer, EMA) — and the command line's `--train` and `--video_gen`
(`python -m mcvd_tpu_torch.main`: `runners.runner.Runner`, checkpoints,
the SMMNIST data path, the SSIM/MSE harness `eval.video_gen.run_video_gen`).
"""

__version__ = "0.1.0"
