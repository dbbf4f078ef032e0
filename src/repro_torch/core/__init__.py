"""The archive's system layer: crypto and the archival pipeline."""
