"""Tools that run the port on the card (counterparts of the repo's `tools/`)."""
