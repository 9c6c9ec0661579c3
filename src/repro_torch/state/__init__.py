"""Elastic compressor-state checkpointing (port of ``repro.state``).

LoCo's quality rests on its *persistent* compensation-error state;
dropping it on resume degrades compression back to naive low-bit.  This
package makes that state (plus master chunks and optimizer moments)
survive topology and policy changes by routing every sharded array
through **logical space**, in the reference's on-disk format, so a
checkpoint written by either framework restores into the other:

``serial``    flatten/dtype-view/atomic-npz primitives + checksums
``manifest``  manifest v2: history, integrity, layout fingerprints
``logical``   chunk/bucket/quantized-state <-> logical f32 views
``reshard``   the cross-(topology, plan) migration driver

``repro_torch.checkpoint.checkpoint`` is the user-facing facade.
"""
from repro_torch.state.manifest import (CheckpointMismatch,
                                        build_fingerprint, fingerprint_diff)
from repro_torch.state.reshard import reshard

__all__ = ["CheckpointMismatch", "build_fingerprint", "fingerprint_diff",
           "reshard"]
