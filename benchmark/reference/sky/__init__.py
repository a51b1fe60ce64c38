"""Skies, one module a kind (``sky/<kind>.py``, the name the
configuration's ``sky.kind`` gives): ``image(sky)``, the raw (W, H, 3)
image or None, which the program is handed too; ``bake(sky, image,
device, dtype)``, the sky as the renderer reads it, a dict with ``kind``;
``color(baked, direction)``, the radiance (N, 3) of each direction."""
