"""Plain references, one per configuration: torch and numpy only."""
