"""Boot-time checkpoint recovery: verify, fall back, restore warm.

The port of `throttlecrab_tpu/persist/recovery.py` for the single-device
limiter and the sharded mesh: the merged rows go through
`tpu/snapshot.py`'s `_bulk_insert`, so on a card through the
`row_scatter` kernel, and a chain written on D shards restores onto any
shard count.  A recovery stamps a "checkpoint-recovery" event on the
flight recorder when one is armed.  The cluster branch is not part of
the port yet.

The scanner's contract is the opposite of THROTTLECRAB_SNAPSHOT_STRICT:
a checkpoint directory is *best-effort durable state*, so corruption
never refuses boot — it narrows what gets restored.  Fallback is
generation-by-generation:

  1. Chains come from the manifest when it verifies, else from a
     directory scan (every ``ckpt-*.tck`` grouped into base +
     consecutive deltas) — a torn manifest costs nothing but the hint.
  2. Within the newest chain, every file re-verifies its CRC.  A
     corrupt *delta* drops itself and everything after it (the chain
     survives one generation shorter); a corrupt *base* abandons the
     whole chain for the next retained one.
  3. Only when every retained chain is unusable does the node boot
     empty — exactly what it would have done without checkpoints.

Dropping tail generations is safe by the GCRA clamp argument: the
restored TATs are older than live state was, and old TATs are
over-allow-only.  Restore-time TTL sweeping (``expiry > now``) happens
on the merged rows before the snapshot restore path (`_bulk_insert`).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np

from ..tpu.snapshot import _bulk_insert, translate_key
from .format import (
    CheckpointCorrupt,
    CheckpointRecord,
    checkpoint_name,
    parse_checkpoint_name,
    read_checkpoint,
    read_manifest,
)

log = logging.getLogger("throttlecrab.persist")


@dataclass
class RecoveryResult:
    """What a boot-time recovery actually restored."""

    restored: int = 0
    generation: int = -1  # newest generation applied
    chain: List[int] = field(default_factory=list)
    corrupt_skipped: int = 0  # generations dropped as torn/corrupt
    chains: List[List[int]] = field(default_factory=list)
    used_manifest: bool = True


def scan_chains(directory: Union[str, Path]) -> List[List[int]]:
    """Reconstruct chains from filenames alone, newest-first.

    Each base starts a chain; a delta extends the chain whose tip is
    exactly one generation older (the writer never leaves holes, so a
    gap means a pruned or lost file and ends the chain there).
    """
    directory = Path(directory)
    try:
        entries = [
            parsed
            for entry in directory.iterdir()
            if (parsed := parse_checkpoint_name(entry.name)) is not None
        ]
    except OSError:
        return []
    entries.sort()
    chains: List[List[int]] = []
    for gen, kind in entries:
        if kind == "base":
            chains.append([gen])
        elif chains and chains[-1][-1] == gen - 1:
            chains[-1].append(gen)
        # else: orphan delta (its base was pruned/corrupted away) —
        # unusable without a base, skip it.
    chains.reverse()
    return chains


def _load_chain(
    directory: Path, chain: List[int], result: RecoveryResult
) -> Optional[List[CheckpointRecord]]:
    """Verify a chain's files; returns the usable prefix (base first),
    or None when the base itself is unusable.  Tail generations that
    fail verification are dropped and counted, not fatal."""
    records: List[CheckpointRecord] = []
    for i, gen in enumerate(chain):
        kind = "base" if i == 0 else "delta"
        try:
            rec = read_checkpoint(directory / checkpoint_name(gen, kind))
            if rec.kind != kind or rec.generation != gen:
                raise CheckpointCorrupt(
                    f"gen {gen}: header disagrees with filename"
                )
        except (CheckpointCorrupt, OSError) as e:
            dropped = len(chain) - i
            result.corrupt_skipped += dropped
            log.warning(
                "checkpoint gen %d unusable (%s): dropping %d "
                "generation(s) from the chain",
                gen,
                e,
                dropped,
            )
            if i == 0:
                return None  # corrupt base: the whole chain is gone
            break
        records.append(rec)
    return records


def recover_into(
    limiter,
    directory: Union[str, Path],
    now_ns: int,
    front=None,
) -> Optional[RecoveryResult]:
    """Restore the newest verifiable chain into an empty limiter.

    Returns None when the directory holds no usable chain at all (boot
    proceeds exactly as without checkpointing).  Never raises for
    corruption — only for a genuinely mis-shaped call (non-empty
    limiter) or state exceeding capacity.
    """
    from ..tpu.limiter import limiter_uses_bytes_keys

    directory = Path(directory)
    if not directory.is_dir():
        return None
    result = RecoveryResult()
    chains = read_manifest(directory)
    if chains is None:
        result.used_manifest = False
        chains = scan_chains(directory)
    if not chains:
        return None

    records: Optional[List[CheckpointRecord]] = None
    chain_used: List[int] = []
    for chain in chains:
        records = _load_chain(directory, chain, result)
        if records:
            chain_used = chain[: len(records)]
            break
        records = None
    # Every retained chain carries the full retained-generation map so
    # the checkpointer resumes numbering past *everything* on disk.
    result.chains = [list(c) for c in chains]
    if records is None:
        return None

    if front is not None:
        front.on_restore()
    if len(limiter) != 0:
        raise ValueError("checkpoint recovery requires an empty limiter")

    # Merge base + deltas: ascending generation order, later rows
    # overwrite earlier (the writer's delta gathers full current rows,
    # so overwrite IS newest-wins).  Keys are translated to the
    # target's identity space first so a base written by a native
    # (bytes-keyed) build merges correctly with deltas for a python
    # target, and vice versa.
    target_bytes_keys = limiter_uses_bytes_keys(limiter)
    merged: Dict = {}
    for rec in records:
        if target_bytes_keys:  # translate_key returns the raw bytes
            keys_t = rec.keys_raw
        else:
            keys_t = [
                translate_key(
                    raw,
                    bool(rec.key_is_bytes[i]),
                    int(rec.key_codec[i]),
                    rec.source_bytes_keys,
                    target_bytes_keys,
                )
                for i, raw in enumerate(rec.keys_raw)
            ]
        merged.update(zip(keys_t, zip(np.asarray(rec.tat).tolist(),
                                      np.asarray(rec.expiry).tolist())))

    # Restore-time TTL sweep across the chain.
    live = [(k, t, e) for k, (t, e) in merged.items() if e > now_ns]
    keys = [k for k, _, _ in live]
    tats = [t for _, t, _ in live]
    exps = [e for _, _, e in live]
    if keys:
        result.restored = _bulk_insert(limiter, keys, tats, exps)
    result.generation = chain_used[-1]
    result.chain = chain_used
    from ..replay.recorder import maybe_record_event

    maybe_record_event(
        "checkpoint-recovery",
        f"gen={result.generation} rows={result.restored} "
        f"skipped={result.corrupt_skipped}",
        now_ns,
    )
    return result
