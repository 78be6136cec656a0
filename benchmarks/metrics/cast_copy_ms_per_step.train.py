"""Device ms a training step of the dtype-cast and layout-copy kernels, the
name classes of cast_copy_kernels.json, in the traced window."""

import json
from pathlib import Path

from harness.readers import kernel_ms_per_step

PATTERNS = json.loads((Path(__file__).with_name("cast_copy_kernels.json"))
                      .read_text())["patterns"]


def read(run):
    return kernel_ms_per_step(run, PATTERNS)
