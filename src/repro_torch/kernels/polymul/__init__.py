"""Negacyclic polynomial multiplication for the R-LWE KEM (kernel B4)."""
