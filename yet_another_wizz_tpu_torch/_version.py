__version__ = "0.6.0"
__version_tuple__ = (0, 6, 0)
