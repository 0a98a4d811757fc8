"""Shared runtime utilities: the canonical knob grammar (`knobs`)."""
