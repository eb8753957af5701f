"""Image files: the OpenEXR codec and the PNG writer and resample."""
