"""Launchers of the port (the reference's `launch/`): `serve`, batched
generation, optionally retrieval-augmented. The reference's mesh, dry-run
and HLO tools wait for the port of training."""
