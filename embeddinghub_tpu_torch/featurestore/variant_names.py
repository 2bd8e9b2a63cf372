"""Autogenerated variant names for run-scoped registrations.

The reference client stamps every ``client.apply()`` session with a
"run" name and uses it as the variant for resources registered without
an explicit one (``client/src/featureform/variant_names_generator.py``,
``register.py:2007-2166``): a timestamp variant by default (flag
``FF_GET_EQUIVALENT_VARIANTS``), an ``adjective_noun`` docker-style name
otherwise.  Word lists here are original (the reference ships 140
adjectives x ~160 scientist surnames; the semantics need any two
human-readable pools, not those specific words).
"""

from __future__ import annotations

import random
from datetime import datetime

from . import feature_flag

_LEFT = [
    "amber", "arc", "atlas", "auric", "axial", "blue", "bold", "brisk",
    "calm", "cedar", "civic", "coral", "crisp", "delta", "dusk", "eager",
    "ember", "fleet", "frost", "gale", "glad", "hazel", "ionic", "ivory",
    "jade", "keen", "lunar", "lush", "mellow", "mint", "noble", "north",
    "ochre", "onyx", "opal", "pale", "prime", "quick", "quiet", "rapid",
    "raven", "rust", "sage", "sharp", "slate", "solar", "spry", "steady",
    "stone", "swift", "tidal", "topaz", "umber", "vivid", "warm", "wild",
    "winter", "zesty",
]

_RIGHT = [
    "anchor", "basin", "beacon", "birch", "bluff", "brook", "cairn",
    "canyon", "cliff", "comet", "cove", "crag", "creek", "crest", "dune",
    "eddy", "fjord", "flume", "ford", "gable", "glade", "grove", "harbor",
    "heath", "hollow", "inlet", "isle", "knoll", "lagoon", "ledge",
    "marsh", "meadow", "mesa", "moor", "orchard", "outlook", "pier",
    "plateau", "quarry", "range", "reef", "ridge", "rill", "shoal",
    "sound", "spire", "spring", "strand", "summit", "terrace", "thicket",
    "trail", "vale", "vista", "wharf",
]


def get_random_name(sep: str = "_") -> str:
    r = random.SystemRandom()
    return f"{r.choice(_LEFT)}{sep}{r.choice(_RIGHT)}"


def get_current_timestamp_variant(
    prefix: str = "", sep: str = "_", include_micro: bool = False
) -> str:
    """Timestamp variant, lexicographically sortable and provider-name
    safe (lowercase, no colons) — the reference's default run naming."""
    fmt = "%Y-%m-%dt%H-%M-%S"
    if include_micro or feature_flag.is_enabled("FF_AUTOVARIANT_MICROSEC"):
        fmt += "_%f"
    stamp = datetime.now().strftime(fmt)
    return stamp if not prefix else f"{prefix}{sep}{stamp}"
