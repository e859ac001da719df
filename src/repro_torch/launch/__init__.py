"""Launchers of the port (the reference's `launch/`): `serve`, batched
generation, optionally retrieval-augmented; `train`, the training loop on
one device or as one rank of a (data, model) mesh under torchrun; `mesh`,
the production meshes of 256 and 512 devices as `DeviceMesh`es (and a
fake world to lay them out without the cards); and the accounting tier —
`specs` (abstract inputs on the meta device, placed by the sharding rules
on a mesh), `hlo` (work, bytes, collectives and memory counted from the
aten ops a call dispatches, per device), `dryrun` (every arch × shape
cell at its published size, on the production meshes or one card),
`roofline` and `report` (their tables)."""
