# Command-line entry points of the port (python -m repro_torch.launch.serve,
# python -m repro_torch.launch.train), the device meshes (mesh) and elastic
# resharding of the train state (elastic).
