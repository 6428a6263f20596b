"""Initial-domain dataset access (counterpart of
``fluidgym_tpu/utils/data_utils.py``, read path only).

Initial domains live under ``<data_path>/initial_domains/<domain_id>/``
(the user data path, checked first) or in the datasets bundled with the JAX
package, ``<repo>/fluidgym_tpu/data/initial_domains/<domain_id>/``.  The
bundle is read in place as files, read-only: nothing of the JAX package is
imported.  Downloading missing datasets from the dataset hub is not ported.
"""

from __future__ import annotations

import csv
import json
import logging
from pathlib import Path

from fluidgym_tpu_torch.config import config

_LOG = logging.getLogger("fluidgym_tpu_torch.data")

__all__ = [
    "BUNDLED_DATA",
    "initial_domain_dir",
    "prepare_initial_domains",
    "load_statistics",
    "load_uncontrolled_episode",
]

#: datasets bundled beside the JAX package (checked after the user data path)
BUNDLED_DATA = Path(__file__).resolve().parents[2] / "fluidgym_tpu" / "data"


def initial_domain_dir(initial_domain_id: str, user_only: bool = False) -> Path:
    """Directory of an initial-domain dataset: the user copy when it exists
    and is non-empty, else the bundled one, else the (missing) user path."""
    user = config.data_path / "initial_domains" / initial_domain_id
    if user_only or (user.exists() and any(user.iterdir())):
        return user
    bundled = BUNDLED_DATA / "initial_domains" / initial_domain_id
    if bundled.exists() and any(bundled.iterdir()):
        return bundled
    return user


def prepare_initial_domains(initial_domain_id: str) -> Path:
    """The dataset directory; warns when neither copy exists (no download)."""
    target = initial_domain_dir(initial_domain_id)
    if not (target.exists() and any(target.iterdir())):
        _LOG.warning(
            "No initial domains for %s (looked in %s and %s). Construct the "
            "env with load_initial_domain=False and "
            "load_domain_statistics=False.",
            initial_domain_id, config.data_path / "initial_domains",
            BUNDLED_DATA / "initial_domains")
    return target


def load_statistics(initial_domain_id: str) -> dict:
    path = initial_domain_dir(initial_domain_id) / "domain_statistics.json"
    if not path.exists():
        raise FileNotFoundError(f"no domain statistics at {path}")
    with open(path) as fh:
        return json.load(fh)


def load_uncontrolled_episode(initial_domain_id: str, mode: str,
                              idx: int) -> list[dict]:
    path = (initial_domain_dir(initial_domain_id)
            / f"{mode}_{idx:02d}_uncontrolled_episode.csv")
    if not path.exists():
        raise FileNotFoundError(f"no uncontrolled episode at {path}")
    with open(path, newline="") as fh:
        return [dict(r) for r in csv.DictReader(fh)]
