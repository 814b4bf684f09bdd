"""Autoregressive blockwise video generation and its metric harness
(counterpart of `mcvd_tpu/eval/video_gen.py`: `make_block_sampler`,
`init_noise`, `slide_cond_window`, `autoregressive_predict`,
`run_video_gen`; upstream runners/ncsn_runner.py:1303-2368).

The public functions take and return the JAX package's layout: folded
(B, H, W, F*C), frame-major. Its NCHW view (`permute(0, 3, 1, 2)`) is a
channels_last tensor with no copy, which is what the network takes.

Random draws come either explicitly (the tests replay the JAX draws) or from
a `torch.Generator`. The harness's metrics run on host numpy, as the JAX
package's; LPIPS and FVD are callables (`eval/lpips.py`, `eval/i3d.py`),
skipped where they are None, as the JAX package skips them without
weights.
"""

from __future__ import annotations

import copy
import itertools
import logging
from math import ceil
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch.func import functional_call

from .. import tracing
from ..data.conditioning import conditioning_fn
from ..data.transforms import data_transform, inverse_data_transform
from ..device import DEFAULT_DEVICE, resolve_device
from ..diffusion import samplers as samplers_mod
from ..diffusion.schedules import DiffusionSchedule
from ..models.ncsnpp import draw_cond_noise
from .metrics import video_metrics_batch

logger = logging.getLogger(__name__)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def make_block_sampler(config, model: torch.nn.Module, sched: DiffusionSchedule,
                       ensemble: bool = False):
    """One reverse-diffusion block: block(params, init, cond, cond_mask=None,
    *, generator=None, inj_noise=None, step_noise=None, cond_noise=None) ->
    (B, H, W, F*C), the JAX sampler's `block(params, key, init, cond,
    cond_mask)` less the key; the sampler is `model.version`'s (DDPM, DDIM,
    FPNDM, or SMLD's annealed Langevin dynamics, which takes only
    `sampling.denoise`, `n_steps_each` (default 200) and `step_lr` (8e-6);
    its `step_noise` is (L, n_steps_each, B, H, W, F*C)).

    With `model.noise_in_cond` every evaluation of the block diffuses cond
    with one draw, as the JAX block passes its one key to each: `cond_noise`
    in cond's NCHW shape. With gamma noise the draw is Gamma(k_cum[labels],
    1), so the JAX block's one key gives another draw at each level:
    `cond_noise` then stacks one draw per evaluation, in the order the
    sampler makes them. Without `cond_noise` the draws come from
    `generator`: once a block, or with gamma once an evaluation.

    `params` is a state dict (name -> tensor) of `model`, for example
    `dict(model.named_parameters())` or `model.state_dict()`, taken at each
    call: the network runs through `torch.func.functional_call` on a copy of
    `model` that the sampler holds in eval mode (dropout off) under
    torch.inference_mode(), so one sampler serves every snapshot of the
    weights and neither building nor calling it touches `model` or its
    `training` flag. Names missing from `params` (the schedule buffers, say)
    come from that copy.

    `sampling.compute_dtype: bfloat16` runs the score network in bf16 (its
    weights, the input, cond and the timestep embedding) while the chain
    math (x0 clip, posterior mean, noise add) stays fp32. The weights are
    cast at each call; a cast is reused while its source is the same tensor
    object at the same `_version`, so an in-place update of a weight (an
    optimizer step) is seen at the next call.

    With `ensemble=True`, `params` is a list of state dicts (checkpoints of
    one model) and eps is the mean of the network's outputs over them, in
    list order, at every step: upstream fast_ensemble_fid's
    sum(scorenets[i](x, ...)) / num_ckpts (ncsn_runner.py:2624-2626), not an
    average of metrics."""
    version = getattr(config.model, "version", "DDPM").upper()
    sampler = samplers_mod.get_sampler(version)
    sampling = config.sampling
    kwargs = dict(
        final_only=True,
        denoise=getattr(sampling, "denoise", True),
        subsample_steps=getattr(sampling, "subsample", None),
        clip_before=getattr(sampling, "clip_before", True),
        t_min=getattr(sampling, "init_prev_t", -1),
        gamma=getattr(config.model, "gamma", False),
    )
    if version == "SMLD":   # the Langevin sampler takes these only
        kwargs = dict(final_only=True, denoise=kwargs["denoise"],
                      n_steps_each=getattr(sampling, "n_steps_each", 200),
                      step_lr=getattr(sampling, "step_lr", 8e-6))
    comp_dtype = _DTYPES[getattr(sampling, "compute_dtype", "float32")]
    net = copy.deepcopy(model).to(comp_dtype).eval()
    casts = {}   # (member, name) -> (source tensor, its _version, the cast)

    def cast(key, t):
        if not t.is_floating_point() or t.dtype == comp_dtype:
            return t
        hit = casts.get(key)
        if hit is None or hit[0] is not t or hit[1] != t._version:
            hit = casts[key] = (t, t._version, t.detach().to(comp_dtype))
        return hit[2]

    noisy_cond = bool(getattr(config.model, "noise_in_cond", False))
    gamma = bool(getattr(config.model, "gamma", False))

    def block(params, init, cond, cond_mask=None, *, generator=None, inj_noise=None,
              step_noise=None, cond_noise=None):
        with tracing.span("sample.block"), torch.inference_mode():
            members = params if ensemble else [params]
            if ensemble and not members:
                raise ValueError("ensemble block sampler: no state dicts")
            weights = [{k: cast((i, k), v) for k, v in p.items()}
                       for i, p in enumerate(members)]
            cond_c = None if cond is None else cond.permute(0, 3, 1, 2).to(comp_dtype)
            noisy = noisy_cond and cond_c is not None
            z = cond_noise
            if noisy and z is None and not gamma:
                z = draw_cond_noise(config, sched, None, cond_c, generator)
            evals = itertools.count()

            def cond_noise_at(labels):
                """The cond-noise draw of this evaluation."""
                e = next(evals)
                if not gamma:
                    return z
                if z is None:
                    return draw_cond_noise(config, sched, labels, cond_c, generator)
                if e >= len(z):
                    raise ValueError(f"cond_noise holds {len(z)} gamma draws, the "
                                     f"sampler makes more evaluations")
                return z[e]

            def eps_fn(x, labels):
                with tracing.span("sample.eval"):
                    x_c = x.permute(0, 3, 1, 2).to(comp_dtype)
                    kw = {"cond_noise": cond_noise_at(labels)} if noisy else {}
                    outs = [functional_call(net, w, (x_c, labels, cond_c, cond_mask), kw)
                            for w in weights]
                    out = outs[0] if len(outs) == 1 else torch.stack(outs).mean(dim=0)
                    return out.permute(0, 2, 3, 1)

            return sampler(init, eps_fn, sched, generator=generator,
                           inj_noise=inj_noise, step_noise=step_noise, **kwargs)[-1]

    return block


def init_noise(config, sched: DiffusionSchedule, shape, *,
               generator: Optional[torch.Generator] = None, device=DEFAULT_DEVICE,
               draw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Initial reverse-diffusion state on `device` (the card unless
    `device="cpu"`; raises without CUDA): N(0, 1) for the DDPM family, with
    gamma noise the centred Gamma g theta_0 - k_0 theta_0 from g ~
    Gamma(k_cum[0], 1), data_transform(U[0, 1)) for SMLD. `draw` is that
    N(0, 1), Gamma or U[0, 1) draw, else it comes from `generator` (on that
    device)."""
    device = resolve_device(device, "init_noise")
    version = getattr(config.model, "version", "DDPM").upper()
    gamma = version != "SMLD" and getattr(config.model, "gamma", False)
    if draw is None:
        if generator is None:
            raise ValueError("init_noise needs a generator or the draw")
        if version == "SMLD":
            draw = torch.rand(shape, generator=generator, device=device)
        elif gamma:
            conc = torch.full(shape, float(sched.k_cum[0]), device=device)
            draw = torch._standard_gamma(conc, generator=generator)
        else:
            draw = torch.randn(shape, generator=generator, device=device)
    draw = draw.to(device)
    if version == "SMLD":
        return data_transform(config, draw)
    if gamma:
        k0, th0 = np.float32(sched.k_cum[0]), np.float32(sched.theta_t[0])
        return draw * float(th0) - float(k0 * th0)
    return draw


def slide_cond_window(config, cond, gen, future: int, one_frame: bool):
    """Autoregressive cond update on folded (B, H, W, F*C) channel slices."""
    C = config.data.channels
    F = config.data.num_frames
    Fc = config.data.num_frames_cond
    if cond is None:
        return gen
    if future == 0:
        if one_frame:
            return torch.cat([cond[..., C:], gen[..., :C]], dim=-1)
        return torch.cat([cond[..., F * C:], gen[..., C * max(0, F - Fc):]], dim=-1)
    if one_frame:
        return torch.cat([cond[..., C: cond.shape[-1] - future * C], gen[..., :C],
                          cond[..., -future * C:]], dim=-1)
    return torch.cat([cond[..., F * C: cond.shape[-1] - future * C],
                      gen[..., C * max(0, F - Fc):], cond[..., -future * C:]], dim=-1)


def autoregressive_predict(config, block_sampler, params, cond, cond_mask,
                           num_frames_pred: int, future: int, sched: DiffusionSchedule,
                           *, generator: Optional[torch.Generator] = None,
                           draws: Optional[Sequence[dict]] = None,
                           unmask_after_first: bool = False):
    """Blockwise generation of num_frames_pred frames with the weights
    `params` (passed to each `block_sampler` call, see `make_block_sampler`);
    returns folded (B, H, W, num_frames_pred*C) in model (transformed) space.

    `draws[i]` may hold block i's explicit draws: "init" (its init noise,
    as `init_noise` returns it), "inj_noise" and "step_noise" (see
    `ddpm_sampler`), "cond_noise" (see `make_block_sampler`); what it lacks
    comes from `generator`. Init noise is re-drawn per block unless
    sampling.init_prev_t > 0, which warm-starts from the previous block."""
    C = config.data.channels
    F = config.data.num_frames
    sz = config.data.image_size
    B = cond.shape[0]
    one_frame = getattr(config.sampling, "one_frame_at_a_time", False)
    n_iter = num_frames_pred if one_frame else ceil(num_frames_pred / F)
    shape = (B, sz, sz, C * F)

    with tracing.span("sample.request"):
        preds = []
        gen = None
        for i_frame in range(n_iter):
            d = draws[i_frame] if draws is not None else {}
            if i_frame == 0 or getattr(config.sampling, "init_prev_t", -1) <= 0:
                init = d.get("init")
                if init is None:
                    init = init_noise(config, sched, shape, generator=generator,
                                      device=cond.device)
            else:
                init = gen
            extra = {"cond_noise": d["cond_noise"]} if "cond_noise" in d else {}
            gen = block_sampler(params, init, cond, cond_mask, generator=generator,
                                inj_noise=d.get("inj_noise"), step_noise=d.get("step_noise"),
                                **extra)
            preds.append(gen)
            if i_frame == n_iter - 1:
                continue
            cond = slide_cond_window(config, cond, gen, future, one_frame)
            if unmask_after_first and i_frame == 0 and cond_mask is not None:
                cond_mask = torch.ones_like(cond_mask)
        return torch.cat(preds, dim=-1)[..., : C * num_frames_pred]


def _metric_stats(values: np.ndarray):
    import scipy.stats as st   # here, not at the top: its import costs a CLI process ~2 s

    avg, std = float(values.mean()), float(values.std())
    sem = st.sem(values) if len(values) > 1 else 0.0
    if sem and sem > 0:
        conf95 = avg - float(st.norm.interval(0.95, loc=avg, scale=sem)[0])
    else:
        conf95 = 0.0
    return avg, std, conf95


def frechet_from_stats(mu1, sigma1, mu2, sigma2, eps: Optional[float] = None) -> float:
    """The Frechet distance of two Gaussians, |mu1 - mu2|^2 + tr(sigma1 +
    sigma2 - 2 sqrt(sigma1 sigma2)), the one copy of this math in the port.
    With `eps`, a square root that is not finite is taken again with eps*I
    added to both covariances (FID's rule, upstream fid_PR.py:53-100); without,
    it stays as scipy gives it (FVD's, upstream models/fvd/fvd.py:275-287).
    `sqrtm` is called without `disp`, which newer scipy releases dropped."""
    from scipy.linalg import sqrtm

    covmean = sqrtm(sigma1 @ sigma2)
    if eps is not None and not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = sqrtm((sigma1 + offset) @ (sigma2 + offset))
    diff = mu1 - mu2
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean.real))


def frechet_distance(x1: np.ndarray, x2: np.ndarray) -> float:
    """FVD/FID Frechet distance between feature sets (upstream
    models/fvd/fvd.py:275-287)."""
    x1, x2 = x1.astype(np.float64), x2.astype(np.float64)
    return frechet_from_stats(x1.mean(axis=0), np.cov(x1, rowvar=False),
                              x2.mean(axis=0), np.cov(x2, rowvar=False))


def _host(config, folded: torch.Tensor) -> np.ndarray:
    """Folded (B, H, W, F*C) in model space -> numpy in [0, 1]."""
    return inverse_data_transform(config, folded).float().cpu().numpy()


def _unfold(a: np.ndarray, C: int) -> np.ndarray:
    """Folded (B, H, W, T*C) -> (B, T, H, W, C)."""
    B, H, W, TC = a.shape
    return a.reshape(B, H, W, TC // C, C).transpose(0, 3, 1, 2, 4)


def _nhwc(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """conditioning_fn's NCHW (channels_last) -> the folded (B, H, W, F*C)."""
    return None if t is None else t.permute(0, 2, 3, 1)


def _with_cond(config, cond: np.ndarray, pred: np.ndarray, future: int) -> np.ndarray:
    """The past cond frames before the prediction, for the FVD embedding
    (upstream ncsn_runner.py:1918-1940): (B, T, H, W, C) in [0, 1]."""
    C = config.data.channels
    if future > 0:
        cond = cond[..., : cond.shape[-1] - future * C]
    return _unfold(np.concatenate([cond, pred], axis=-1), C)


def run_video_gen(config, model, params, sched: DiffusionSchedule, test_loader,
                  generator: Optional[torch.Generator], *, ckpt: int = 0,
                  max_data_iter: Optional[int] = None, preds_per_test: int = 1,
                  lpips_fn: Optional[Callable] = None,
                  i3d_embedder: Optional[Callable] = None,
                  save_artifacts: Optional[Callable] = None,
                  block_sampler: Optional[Callable] = None) -> Dict:
    """The three-pass metric harness (upstream ncsn_runner.py:1303-2368):
    (1) prediction or interpolation, fully conditioned; (2) pure prediction
    with the future masked, where the model was trained for interpolation
    and prediction; (3) unconditional generation (FVD only), unmasked after
    the first block. `test_loader` yields raw (B, T, H, W, C) clips in [0, 1]
    (numpy, or (clips, labels)), each video repeated preds_per_test times;
    `params` (a state dict of `model`) go to `block_sampler` (by default
    `make_block_sampler`'s) on their device; draws come from `generator`.
    Returns the vid_metrics dict in the JAX package's key layout: per-video
    best of preds_per_test, then mean, std and 95% interval. A config with
    no conditioning frames (`data.num_frames_cond` 0: the image configs)
    has no video to predict: it raises, naming `--sample`, which samples
    it (the JAX package fails there too, on the missing cond)."""
    data = config.data
    if data.num_frames_cond == 0:
        raise ValueError(
            f"video_gen: {data.dataset} has data.num_frames_cond 0, so there are no "
            f"conditioning frames to predict from; sample this config with --sample")
    condp = getattr(data, "prob_mask_cond", 0.0)
    future = getattr(data, "num_frames_future", 0)
    futrp = getattr(data, "prob_mask_future", 0.0)
    sync = getattr(data, "prob_mask_sync", False)
    conditional = data.num_frames_cond > 0
    calc_ssim = getattr(config.sampling, "ssim", False)
    calc_fvd = getattr(config.sampling, "fvd", False) and i3d_embedder is not None
    # FVD pass selection (upstream ncsn_runner.py:1313-1340)
    calc_fvd1 = calc_fvd and condp == 0.0
    calc_fvd2 = calc_fvd and condp == 0.0 and future > 0 and futrp > 0 and not sync
    calc_fvd3 = calc_fvd and condp > 0.0
    is_mnist = data.dataset.upper() in ("STOCHASTICMOVINGMNIST", "MOVINGMNIST")
    C = data.channels
    device = next(iter(params.values())).device
    if block_sampler is None:
        block_sampler = make_block_sampler(config, model, sched)
    max_data_iter = max_data_iter or getattr(config.sampling, "max_data_iter", 1)

    vid = {k: [] for k in ("mse", "ssim", "lpips")}
    vid2 = {k: [] for k in ("mse", "ssim", "lpips")}
    emb = {k: [] for k in ("real", "fake", "real2", "fake2", "real3", "fake3")}
    second_calc = False

    def predict(cond, cond_mask, n_frames, unmask=False):
        return _host(config, autoregressive_predict(
            config, block_sampler, params, cond, cond_mask, n_frames, future, sched,
            generator=generator, unmask_after_first=unmask))

    def score(into, real, pred):
        n = min(real.shape[-1] // C, pred.shape[-1] // C)
        r5, p5 = _unfold(real, C)[:, :n], _unfold(pred, C)[:, :n]
        m = video_metrics_batch(r5, p5, is_mnist=is_mnist, calc_ssim=calc_ssim)
        into["mse"] += m["mse"]
        into["ssim"] += m["ssim"]
        into["lpips"] += (list(lpips_fn(r5, p5)) if lpips_fn is not None
                          else [0.0] * len(m["mse"]))

    for i, batch in enumerate(test_loader):
        if i >= max_data_iter:
            break
        X = batch[0] if isinstance(batch, tuple) else batch
        X = torch.as_tensor(X).to(device=device, dtype=torch.float32)
        Xt = data_transform(config, X)

        # ---- (1) pred or interp, fully conditioned
        num_frames_pred = config.sampling.num_frames_pred if future == 0 else data.num_frames
        real_f, cond, cond_mask = conditioning_fn(
            config, Xt, num_frames_pred=num_frames_pred, prob_mask_cond=0.0,
            prob_mask_future=0.0, conditional=conditional)
        cond = _nhwc(cond)
        real = _host(config, _nhwc(real_f))
        pred = predict(cond, cond_mask, num_frames_pred)
        cond_np = None if cond is None else _host(config, cond)
        if real.shape[-1] < pred.shape[-1]:
            logger.warning("predicting beyond training data range; metrics zeroed")
            for k in vid:
                vid[k] += [0.0] * len(pred)
        else:
            score(vid, real, pred)
        if calc_fvd1:
            emb["real"].append(i3d_embedder(_with_cond(config, cond_np, real, future)))
            emb["fake"].append(i3d_embedder(_with_cond(config, cond_np, pred, future)))

        # ---- (2) pure prediction when pass 1 was interpolation
        if future > 0 and futrp > 0.0 and not sync:
            second_calc = True
            num_frames_pred2 = config.sampling.num_frames_pred
            real2_f, cond2, cond_mask2 = conditioning_fn(
                config, Xt, num_frames_pred=num_frames_pred2, prob_mask_cond=0.0,
                prob_mask_future=1.0, conditional=conditional)
            cond2 = _nhwc(cond2)
            real2 = _host(config, _nhwc(real2_f))
            pred2 = predict(cond2, cond_mask2, num_frames_pred2)
            cond2_np = None if cond2 is None else _host(config, cond2)
            score(vid2, real2, pred2)
            if calc_fvd2:
                emb["real2"].append(i3d_embedder(_with_cond(config, cond2_np, real2, future)))
                emb["fake2"].append(i3d_embedder(_with_cond(config, cond2_np, pred2, future)))

        # ---- (3) unconditional generation (FVD only); every mask draw
        # (u > 1) drops its frames, so the draws are zeros
        if calc_fvd3:
            nfp3 = data.num_frames_cond + config.sampling.num_frames_pred
            zeros = torch.zeros(X.shape[0], device=device)
            _, cond3, cond_mask3 = conditioning_fn(
                config, Xt, num_frames_pred=nfp3, prob_mask_cond=1.0, prob_mask_future=1.0,
                conditional=conditional, mask_draws={"cond": zeros, "future": zeros})
            pred3 = predict(_nhwc(cond3), cond_mask3, nfp3, unmask=True)
            realX = X.cpu().numpy()
            T3 = min(realX.shape[1], pred3.shape[-1] // C)
            emb["real3"].append(i3d_embedder(realX[:, :T3]))
            emb["fake3"].append(i3d_embedder(_unfold(pred3, C)[:, :T3]))

        if save_artifacts is not None and i == 0:
            # the first batch of every pass that ran (upstream ncsn_runner.py:1984-2190)
            save_artifacts(real=real, pred=pred, cond=cond_np)
            if second_calc:
                save_artifacts(real=real2, pred=pred2, cond=cond2_np, tag="pass2")
            if calc_fvd3:
                save_artifacts(real=None, pred=pred3, cond=None, tag="gen")

    # ---- aggregate: best of preds_per_test (upstream ncsn_runner.py:2196-2229)
    if not vid["mse"]:
        raise ValueError(
            "run_video_gen consumed zero batches — the loader was empty "
            "(e.g. sampling.batch_size > len(test_ds)*preds_per_test with "
            "drop_last); shrink sampling.batch_size or grow the test split")

    def best(v):
        mse = np.asarray(v["mse"])
        return ((mse.reshape(-1, preds_per_test).min(-1)),
                (10 * np.log10(1 / np.maximum(mse, 1e-20))).reshape(-1, preds_per_test).max(-1),
                np.asarray(v["ssim"]).reshape(-1, preds_per_test).max(-1),
                np.asarray(v["lpips"]).reshape(-1, preds_per_test).min(-1))

    def fvd_stuff(fake, real_):
        avg_fvd = frechet_distance(fake, real_)
        if preds_per_test > 1:
            fvds = [frechet_distance(fake[t::preds_per_test], real_)
                    for t in range(preds_per_test)]
            mean, stdv = float(np.mean(fvds)), float(np.std(fvds))
            import scipy.stats as st

            sem = st.sem(fvds)
            conf = mean - float(st.norm.interval(0.95, loc=mean, scale=sem)[0]) if sem > 0 else 0.0
            return avg_fvd, mean, stdv, conf
        return avg_fvd, -1, -1, -1

    vm = {"ckpt": ckpt, "preds_per_test": preds_per_test}
    for task, v in (("", vid), ("2", vid2)):
        if task == "2" and not second_calc:
            continue
        for name, arr in zip(("mse", "psnr", "ssim", "lpips"), best(v)):
            avg, std, conf = _metric_stats(arr)
            key = name + task
            vm[key], vm[f"{key}_std"], vm[f"{key}_conf95"] = avg, std, conf
    for task, on in (("", calc_fvd1), ("2", calc_fvd2), ("3", calc_fvd3)):
        if on and emb["real" + task]:
            a, m_, s_, c_ = fvd_stuff(np.concatenate(emb["fake" + task]),
                                      np.concatenate(emb["real" + task]))
            vm.update({f"fvd{task}": a, f"fvd{task}_traj_mean": m_,
                       f"fvd{task}_traj_std": s_, f"fvd{task}_traj_conf95": c_})
    return vm
