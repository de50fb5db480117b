"""Dataset converters (the port's counterparts of the repo's
``tools/convert_datasets``), each run as ``python -m
vps_torch.tools.convert_datasets.<name>``."""
