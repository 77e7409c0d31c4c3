"""Small argv interpreter matching the reference CLI flag dialect
(`-flag value` pairs, `{a,b}` size syntax — ojph_arg.h:52-272 and the
list interpreters of ojph_compress.cpp:51-357)."""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple


class ArgError(ValueError):
    pass


class Args:
    def __init__(self, argv: List[str]):
        self.kv: Dict[str, str] = {}
        i = 0
        while i < len(argv):
            a = argv[i]
            if not a.startswith('-'):
                raise ArgError(f'unexpected argument {a!r}')
            if i + 1 >= len(argv):
                raise ArgError(f'missing value for {a}')
            self.kv[a] = argv[i + 1]
            i += 2
        self.used = set()

    def get(self, flag: str, default=None) -> Optional[str]:
        if flag in self.kv:
            self.used.add(flag)
            return self.kv[flag]
        return default

    def get_bool(self, flag: str, default=False) -> bool:
        v = self.get(flag)
        if v is None:
            return default
        if v.lower() in ('true', '1', 'yes'):
            return True
        if v.lower() in ('false', '0', 'no'):
            return False
        raise ArgError(f'{flag} expects true/false, got {v!r}')

    def get_int(self, flag: str, default=None) -> Optional[int]:
        v = self.get(flag)
        return default if v is None else int(v)

    def get_float(self, flag: str, default=None) -> Optional[float]:
        v = self.get(flag)
        return default if v is None else float(v)

    def get_size(self, flag: str, default=None) -> Optional[Tuple[int,
                                                                  int]]:
        """Parse '{w,h}'."""
        v = self.get(flag)
        if v is None:
            return default
        m = re.fullmatch(r'\{(\d+),(\d+)\}', v)
        if not m:
            raise ArgError(f'{flag} expects {{w,h}}, got {v!r}')
        return int(m.group(1)), int(m.group(2))

    def get_size_list(self, flag: str) -> Optional[List[Tuple[int, int]]]:
        """Parse '{a,b},{c,d},...'."""
        v = self.get(flag)
        if v is None:
            return None
        items = re.findall(r'\{(\d+),(\d+)\}', v)
        if not items or len(','.join(
                '{%s,%s}' % t for t in items)) != len(v):
            raise ArgError(f'{flag} expects {{a,b}},{{c,d}}..., got {v!r}')
        return [(int(a), int(b)) for a, b in items]

    def get_int_list(self, flag: str) -> Optional[List[int]]:
        v = self.get(flag)
        if v is None:
            return None
        return [int(x) for x in v.split(',')]

    def check_unused(self):
        unused = set(self.kv) - self.used
        if unused:
            raise ArgError('unknown arguments: ' + ', '.join(sorted(
                unused)))
