# Model stack (PyTorch port of repro.models) for every family: layers, the
# chunked attention with its backward and the plain masked one, MoE, Mamba2,
# and the transformer's forward (with remat), prefill and decode.
