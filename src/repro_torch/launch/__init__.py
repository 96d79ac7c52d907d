"""Process launch for the port's distributed engine (``mesh``)."""
