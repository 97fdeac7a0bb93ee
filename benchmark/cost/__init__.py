"""Frozen operation and byte counts, and the card's published peaks."""
