"""Launchers of the port (the reference's `launch/`): `serve`, batched
generation, optionally retrieval-augmented; `train`, the training loop on
one device; and the accounting tier on one card — `specs` (abstract
inputs on the meta device), `hlo` (work, bytes and memory counted from
the aten ops a call dispatches), `dryrun` (every arch × shape cell at its
published size), `roofline` and `report` (their tables). The reference's
`mesh` (TPU meshes of 256 and 512 chips) is not ported: one card has no
mesh."""
