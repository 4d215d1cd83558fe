"""Configuration of the port (dataset configuration)."""
