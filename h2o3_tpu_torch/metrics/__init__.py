"""Model metrics on the device."""
