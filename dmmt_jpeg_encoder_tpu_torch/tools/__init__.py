"""Measurement scripts for the port; each runs on a CUDA card only."""
