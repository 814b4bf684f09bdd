from .video_gen import (autoregressive_predict, init_noise, make_block_sampler,
                        run_video_gen, slide_cond_window)

__all__ = ["autoregressive_predict", "init_noise", "make_block_sampler", "run_video_gen",
           "slide_cond_window"]
