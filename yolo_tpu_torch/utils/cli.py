"""Dash/underscore-agnostic argparse (the port's copy of
``yolo_tpu/utils/cli.py``).

Every long flag registered through ``FlexParser`` accepts both spellings
(``--img-size`` and ``--img_size``); the first spelling passed stays the
canonical one (dest, help, usage).
"""

from __future__ import annotations

import argparse


class FlexParser(argparse.ArgumentParser):
    def add_argument(self, *args, **kwargs):  # noqa: D102
        opts = []
        for a in args:
            if isinstance(a, str) and a.startswith('--') and len(a) > 3:
                base = a[2:]
                for v in (base, base.replace('_', '-'),
                          base.replace('-', '_')):
                    flag = '--' + v
                    if flag not in opts:
                        opts.append(flag)
            elif a not in opts:
                opts.append(a)
        return super().add_argument(*opts, **kwargs)

    def _get_option_tuples(self, option_string):
        # prefix abbreviations (--img for --img-size) must not become
        # "ambiguous" just because both spellings of ONE action match
        tuples = super()._get_option_tuples(option_string)
        seen, out = set(), []
        for t in tuples:
            if id(t[0]) not in seen:
                seen.add(id(t[0]))
                out.append(t)
        return out
