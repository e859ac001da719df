"""Launchers of the port (the reference's `launch/`): `serve`, batched
generation, optionally retrieval-augmented, and `train`, the training
loop on one device. The reference's mesh, dry-run and HLO tools are not
ported: they lay programs out over many TPU chips."""
