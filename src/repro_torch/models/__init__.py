# Model stack (PyTorch port of repro.models) for the dense family: layers,
# plain masked attention, and the transformer's forward, prefill and decode.
