"""Model, parameter initialisation, conversion and sizing."""
