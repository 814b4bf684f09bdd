"""Where the metric networks' weight files are found (counterpart of
`mcvd_tpu/eval/weights.py`).

Upstream downloads them at run time (the I3D TorchScript, pt_inception,
torchvision's AlexNet and the LPIPS lin heads); nothing is fetched here. A
file is taken from the config's path (`eval.*`), else from
`$MCVD_WEIGHTS_DIR`, else from `weights/` in the temporary directory
(`/tmp/weights` unless TMPDIR says otherwise), under the canonical names.
A config path that names no file raises: the JAX package falls through to
the defaults there, which can drop a metric the user asked for in silence.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

# canonical file names per metric
I3D = "i3d_torchscript.pt"
INCEPTION = "inception.pt"
LPIPS_LIN = "lpips_alex_lin.pth"
ALEXNET = "alexnet.pth"


def default_dirs():
    dirs = []
    env = os.environ.get("MCVD_WEIGHTS_DIR")
    if env:
        dirs.append(env)
    dirs.append(os.path.join(tempfile.gettempdir(), "weights"))
    return dirs


def find_weights(config_path: Optional[str], filename: str) -> Optional[str]:
    """The config's path where one is given (FileNotFoundError if it is not
    a file), else the first default directory that holds `filename`, else
    None."""
    if config_path:
        if not os.path.isfile(config_path):
            raise FileNotFoundError(f"{config_path} (a metric weights path of the config) "
                                    "is not a file")
        return config_path
    for d in default_dirs():
        p = os.path.join(d, filename)
        if os.path.isfile(p):
            return p
    return None
