"""Earth models and the Fast camera."""
