"""Model parameter layouts and initialization."""
