"""Terrain tiles: readers, the tile store and device sampling."""
