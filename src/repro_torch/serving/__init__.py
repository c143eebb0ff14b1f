"""Network serving: wire protocol, admission scheduler, inference server."""
