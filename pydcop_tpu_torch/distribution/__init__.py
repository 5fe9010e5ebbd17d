"""Placement hints (only what the yaml loader needs)."""
