"""Filesystem layout: copy of ``home()`` from
``skypilot_tpu/utils/paths.py``. Everything lives under
$SKYPILOT_TPU_HOME (default ~/.skypilot_tpu), so the port's event and
flight logs land where the reference CLI (``skytpu flight --local``,
``skytpu trace``) looks for them."""

from __future__ import annotations

import os


def home() -> str:
    root = os.environ.get("SKYPILOT_TPU_HOME",
                          os.path.expanduser("~/.skypilot_tpu"))
    os.makedirs(root, exist_ok=True)
    return root
