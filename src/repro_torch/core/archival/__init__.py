"""Archival pipeline: sealed RAID stripes, restore, degraded read, scrub."""
