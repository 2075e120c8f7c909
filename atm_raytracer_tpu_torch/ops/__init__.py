"""Device ops: the crossing combine, coloring and compositing."""
