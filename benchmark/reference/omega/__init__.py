"""The march's over-relaxation rules, one module a policy
(``omega/<policy>.py``, the name ``render.omega_policy`` gives):
``trip(t, w, s, d, dist, done, rc)`` returns each lane's ``(rollback,
w_next)`` for a trip, from its carried ``t, w, s, d``, the distance at
its point and the lanes done."""
