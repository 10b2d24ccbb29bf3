"""No C++ feature store here: the driver keeps the Python one."""


def available() -> bool:
    return False
