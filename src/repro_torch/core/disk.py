"""Legacy entry points of the disk tier, now in ``core/storage.py`` (port of
``repro.core.disk``).

``save_to_disk`` / ``load_from_disk`` keep the legacy pickle layout (and its
pre-codec migration) alive for old callers and old on-disk checkpoints; new
code configures ``EngineConfig.tiers`` with ``storage.disk(...)`` /
``storage.shared_dir(...)`` and lets the engine flush and escalate.
"""

from __future__ import annotations

from repro_torch.core.storage import load_from_disk, save_to_disk  # noqa: F401
