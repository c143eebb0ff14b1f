"""Network serving: wire protocol, admission scheduler, LM serving engine,
inference server."""
