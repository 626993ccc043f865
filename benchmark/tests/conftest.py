"""The benchmark's tests take ``tinyroot.tiny_root`` for
``benchtools.tiny_root`` (``tinyroot.py`` says why)."""

import benchtools
import tinyroot

benchtools.tiny_root = tinyroot.tiny_root
