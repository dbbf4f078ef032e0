"""Hybrid encryption: R-LWE KEM for session keys, ChaCha20 for bulk bytes."""
