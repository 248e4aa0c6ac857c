"""Data generators and bulk loaders, one module a configuration kind."""
