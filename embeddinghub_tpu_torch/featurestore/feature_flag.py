"""Environment-driven feature flags.

Mirrors the reference client's ``feature_flag.is_enabled`` contract
(``client/src/featureform/feature_flag.py``): an env var set to the
string "true" (case-insensitive) enables the flag; anything else
disables it; unset falls back to the caller's default.
"""

from __future__ import annotations

import os


def is_enabled(feature_name: str, default: bool = False) -> bool:
    value = os.getenv(feature_name)
    if value is not None:
        return value.lower() == "true"
    return default
