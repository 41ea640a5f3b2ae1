from . import common
