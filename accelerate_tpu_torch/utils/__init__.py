"""Port utilities: device resolution and plugin dataclasses."""
