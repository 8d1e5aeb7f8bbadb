"""Crash durability: incremental checkpointing + torn-write recovery.

The port of `throttlecrab_tpu/persist/`; its files are byte-identical to
the JAX package's for the same state, so either package recovers the
other's chains.

A background checkpointer (checkpoint.py) periodically writes
generation-numbered, CRC-checksummed, fsynced checkpoint files — a
full base plus incremental deltas of slots dirtied since the previous
generation — with a manifest naming the retained chains and bounded
retention.  A boot-time scanner (recovery.py) verifies checksums and
falls back generation-by-generation past torn or corrupt files, so an
unplanned death (SIGKILL, OOM, power loss) restarts warm instead of
empty.  Everything restored is over-allow-only by the GCRA clamp —
stale state can never manufacture a wrong deny.
"""

from .checkpoint import BASE_EVERY, Checkpointer  # noqa: F401
from .format import (  # noqa: F401
    MANIFEST_NAME,
    CheckpointCorrupt,
    CheckpointRecord,
    checkpoint_name,
    decode_checkpoint,
    encode_checkpoint,
    parse_checkpoint_name,
    read_checkpoint,
    read_manifest,
    write_manifest,
)
from .recovery import (  # noqa: F401
    RecoveryResult,
    recover_into,
    scan_chains,
)
