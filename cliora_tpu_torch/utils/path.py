"""(reference: cliora/utils/path.py)"""

import os


def package_path() -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.abspath(os.path.join(here, "..", ".."))
