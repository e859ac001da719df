"""Training of the port (the reference's `train/`): AdamW over f32 master
weights (`optimizer`), the train step with microbatch accumulation
(`step`), atomic checkpoints in the reference's npz layout
(`checkpoint`) and the fault-tolerant loop (`loop`)."""
