"""Meshes of shards, their halo exchange and their flag votes."""
