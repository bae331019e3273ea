"""Launch layer: the rank mesh and the application shape cells."""
