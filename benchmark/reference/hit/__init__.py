"""The march's hit tests, one module a criterion (``hit/<criterion>.py``,
the name ``render.hit_criterion`` gives): ``hit(dist, t, rc)``, whether
each lane's distance ``dist`` at ray parameter ``t`` is a hit."""
