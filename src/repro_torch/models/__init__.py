"""The model stack of the port (the reference's `models/`): configs,
layers, the attention, MoE and recurrent mixers, the flash forward and
backward of chunked causal attention, and the decoder's forward, loss,
prefill and decode (`model`)."""
