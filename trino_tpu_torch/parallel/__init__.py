"""Multi-device execution. This engine runs on a mesh of one device: every
exchange is the identity and every cross-device reduction is its input."""
