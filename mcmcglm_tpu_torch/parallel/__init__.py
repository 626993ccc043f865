"""On-device collection diagnostics of the port (``pooled``)."""
