"""The model stack of the port (the reference's `models/`): configs,
layers, GQA attention with its chunked flash forward, and the dense
decoder's forward / prefill / decode (`model`)."""
