"""Signed distances, one module a shape (``shapes/<shape>.py``, the name an
object's ``shape`` gives): ``ID``, the program's shape id, by which the
scene sorts its objects; ``WEIGHTS``, whether the shape reads the scene's
network weights; ``sd(scene, lo, hi, p, chains)``, the distances (..., k)
of object-space points ``p`` (..., k, 3) to the scene's objects
``lo:hi``, all of this shape."""
