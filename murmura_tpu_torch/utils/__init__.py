"""Config -> object wiring."""
