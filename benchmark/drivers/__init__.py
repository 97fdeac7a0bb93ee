"""One driver a traffic kind: ``setup``, ``window`` and ``check``."""
