"""Frame-triplet index and synthetic fixtures of the port."""
