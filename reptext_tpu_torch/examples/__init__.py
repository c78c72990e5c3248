"""In-process examples on the port: ``generate.predict`` and ``inpaint.inpaint_text``."""
