"""Options, registries, checkpoints and logging of the port."""
