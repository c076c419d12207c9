"""Logger, sample rendering and checkpoint files."""
