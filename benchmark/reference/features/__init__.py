"""Render paths beyond the plain one, one module a feature
(``features/<name>.py``), each named in a configuration's
``reference_features``: the module defines any of the reference's stages
(``reference.BASE``: ``march``, ``bounce``, ``wavefront_step``,
``render_frame``, ``megakernel_trace``, ``render_pixels``,
``interaction``) under the stage's name, with the base's signature, and
the reference runs it in the base's place. A render setting in
``render.OPTIONAL`` that a configuration turns on is refused unless a
feature of the same name is listed. None is needed by the configurations
there are."""
