"""Model and run configurations (`base`) and the registry of the ten
architectures (`registry.get_config`)."""
