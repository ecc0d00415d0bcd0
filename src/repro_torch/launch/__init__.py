"""Launch entry points of the port (counterpart of ``repro.launch``):
``python -m repro_torch.launch.fleet`` serves many tenants from one card."""
