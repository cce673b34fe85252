"""Builds the optional native extension (graphlap/native/codec.c).

Kept alongside pyproject.toml because ext_modules still need setup.py; the
extension is optional — import falls back to numpy paths if the build or
load fails (graphlap/native/__init__.py).
"""

from setuptools import Extension, setup
from setuptools.command.build_ext import build_ext


class OptionalBuildExt(build_ext):
    """Don't fail the whole install if the C toolchain is missing."""

    def run(self):
        try:
            super().run()
        except Exception as exc:      # pragma: no cover
            print(f"warning: native extension skipped ({exc})")

    def build_extension(self, ext):
        try:
            super().build_extension(ext)
        except Exception as exc:      # pragma: no cover
            print(f"warning: native extension {ext.name} skipped ({exc})")


setup(
    ext_modules=[
        Extension(
            "graphlap.native._native",
            sources=["graphlap/native/codec.c"],
            extra_compile_args=["-O3", "-std=c11"],
        ),
    ],
    cmdclass={"build_ext": OptionalBuildExt},
)
