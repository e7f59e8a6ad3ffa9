"""The persisted verdict of the int8-tower quality gate.

A copy of ``gate_file_path`` and ``read_gate_default`` of
``v2ap_tpu/evaluation/int8_gate.py``, which ``V2APipeline`` consults, as the
JAX pipeline does, when ``quantize_towers`` is None and
``V2AP_INT8_TOWERS`` is unset. The gate itself (the FAD A/B of int8 and
bf16 towers) is not ported.
"""

from __future__ import annotations

import json
import os
from typing import Optional


def gate_file_path() -> str:
    """Where the verdict is kept: ``V2AP_INT8_GATE_FILE``, else
    ``int8_gate.json`` in the package directory."""
    return os.environ.get(
        "V2AP_INT8_GATE_FILE",
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
            __file__))), "int8_gate.json"))


def read_gate_default() -> Optional[bool]:
    """The persisted verdict, or None when the gate has never run or its
    file cannot be read."""
    path = gate_file_path()
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return bool(json.load(f)["int8_default"])
    except (OSError, ValueError, KeyError, TypeError):
        return None
