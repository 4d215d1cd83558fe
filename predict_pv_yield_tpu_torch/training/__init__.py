"""Training of the port: the engine, callbacks, loggers and the pipeline."""
