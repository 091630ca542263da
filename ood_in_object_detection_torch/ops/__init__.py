"""The port's kernel wrappers. Importing the package registers the
``ood_torch`` operators that the wrappers call (:mod:`.library`)."""

from . import library  # noqa: F401
