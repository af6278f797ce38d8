"""Diversity-combiner tests, modelled on the reference suite
(test/test_trustProcessor/): Worker bookkeeping unit tests, vote kernel
tests, and process-level tests through real ZMQ sockets with randomly
delayed, corrupted multi-channel streams."""

import time

import numpy as np
import pytest
import zmq

from pycusdr_tpu.combine import (
    SoftCombiner,
    Worker,
    WorkerIdError,
    do_vote2,
    do_voteN,
    xcorr_peak,
)


def wdict(workerId, bits, trust=None, count=0, voteGroup=0):
    return {
        "workerId": workerId,
        "count": count,
        "timestamp": time.time(),
        "voteGroup": voteGroup,
        "doppler": 0.0,
        "doppler_std": 0.0,
        "spSymEst": 16.0,
        "SNR": 10.0,
        "baudRate": 9600,
        "protocol": "bench_FSK",
        "data": np.asarray(bits, np.int8),
        "trust": np.full(len(bits), 2, np.int8) if trust is None else np.asarray(trust, np.int8),
    }


def longest_match_run(a, b):
    """Longest run of consecutive equal bits (reference consecutiveOne)."""
    eq = np.asarray(a) == np.asarray(b)
    best = cur = 0
    for v in eq:
        cur = cur + 1 if v else 0
        best = max(best, cur)
    return best


class TestWorker:
    def test_insert_and_get(self):
        rng = np.random.RandomState(0)
        bits = rng.randint(0, 2, 100)
        w = Worker(wdict("A", bits))
        d, t = w.getData()
        np.testing.assert_array_equal(d, bits)
        assert len(t) == 100

        more = rng.randint(0, 2, 50)
        w.insertData(wdict("A", more, count=1))
        d, _ = w.getData()
        assert len(d) == 150
        np.testing.assert_array_equal(d[100:], more)

    def test_wrong_id_rejected(self):
        w = Worker(wdict("A", [1, 0, 1]))
        with pytest.raises(WorkerIdError):
            w.insertData(wdict("B", [1, 1]))

    def test_own_head_cursor(self):
        w = Worker(wdict("A", np.ones(40)))
        out = w.getSelf()
        assert len(out["data"]) == 40
        out = w.getSelf()
        assert len(out["data"]) == 0  # already served
        w.insertData(wdict("A", np.zeros(10), count=1))
        out = w.getSelf()
        np.testing.assert_array_equal(out["data"], np.zeros(10))

    def test_per_slave_cursors(self):
        w = Worker(wdict("A", np.arange(20) % 2))
        a = w.getSelf("peer1")
        assert len(a["data"]) == 20
        w.insertData(wdict("A", np.ones(5), count=1))
        b = w.getSelf("peer1")
        assert len(b["data"]) == 5
        c = w.getSelf("peer2")  # fresh cursor sees everything
        assert len(c["data"]) == 25

    def test_update_idx_rollback(self):
        w = Worker(wdict("A", np.ones(30)))
        out = w.getSelf()
        assert len(out["data"]) == 30
        w.updateIdx(len(out["data"]), dataUsed=False)
        again = w.getSelf()
        assert len(again["data"]) == 30

    def test_time_pruning(self):
        w = Worker(wdict("A", np.ones(64)), timestampTimeOut=0.05)
        time.sleep(0.1)
        w.insertData(wdict("A", np.zeros(16), count=1))
        w.removeOldData()
        d, _ = w.getData()
        assert len(d) == 16
        np.testing.assert_array_equal(d, np.zeros(16))


class TestVotes:
    def test_vote2_agreement_and_resolution(self):
        bitsM = np.array([1, 0, 1, 0, 1], np.int8)
        bitsS = np.array([1, 0, 0, 1, 1], np.int8)
        trustM = np.array([2, 2, 2, -1, -1], np.int8)
        trustS = np.array([2, 2, -1, 2, 2], np.int8)
        bits, trust = do_vote2(bitsM, trustM, bitsS, trustS)
        # idx2: slave distrusts -> master bit; idx3: master distrusts -> slave bit
        np.testing.assert_array_equal(bits, [1, 0, 1, 1, 1])
        assert trust[0] == 1 and trust[1] == 1  # agreement (positive-good)
        assert np.isclose(trust[2], 0.7)  # master trust
        assert np.isclose(trust[3], 0.3)  # slave trust

    def test_vote2_pins_reference_semantics(self):
        """Regression-lock the documented deviations from the reference
        _doVote2 (softCombiner.py:620-660).

        Bit selection is reference-exact, including the quirky
        trustS==0 branch; the trust sign convention deliberately
        deviates (trust_ref = -trust_here) so that positive always
        means confident across both vote kernels — see votes.py
        docstring."""
        # one bit per branch of the reference's disagreement loop:
        #  idx0 agree; idx1 slave<0,master ok; idx2 slave<0,master<0;
        #  idx3 master<0,slave>0; idx4 master<0,slave==0 (halved-bit
        #  branch: reference keeps (bM+bS)//2 = 0 with DEFAULT trust);
        #  idx5 both qualified but disagree; idx6 master==0,slave<0
        bitsM = np.array([1, 1, 1, 0, 1, 1, 1], np.int8)
        bitsS = np.array([1, 0, 0, 1, 0, 0, 0], np.int8)
        trustM = np.array([2, 2, -1, -1, -1, 2, 0], np.int8)
        trustS = np.array([2, -1, -1, 2, 0, 2, -1], np.int8)
        bits, trust = do_vote2(bitsM, trustM, bitsS, trustS)
        # reference bit outcomes, hand-walked through softCombiner.py:640-657
        np.testing.assert_array_equal(bits, [1, 1, 1, 1, 0, 1, 1])
        ours = [1.0, 0.7, -1.0, 0.3, 1.0, 0.1, 0.7]
        np.testing.assert_allclose(trust, ours)
        # the reference would emit exactly the negation of these on the
        # wire (softCombiner.py:660); pin the mapping so any future
        # change to either convention is visible
        np.testing.assert_allclose(-np.asarray(ours), -trust)
        # the normalized convention must agree in sign with do_voteN's
        # for confident outcomes: every qualified resolution positive,
        # only the double-distrust case negative
        assert (trust < 0).sum() == 1 and trust[2] < 0

    def test_voteN_two_slave_wrong_master(self):
        """Pin the do_voteN threshold fix (votes.py docstring vs
        reference softCombiner.py:599-600): with 2 agreeing slaves and a
        wrong master, the slaves must win. Under the reference's
        threshold (numVoters/2 + masterVoteWeight/2 with the master also
        counted as a voter) a wrong master was unbeatable at N=3."""
        bitsM = np.zeros(8, np.int8)  # master is wrong everywhere
        truth = np.ones(8, np.int8)
        trust = np.full(8, 2, np.int8)
        bits, t = do_voteN(bitsM, trust, [truth, truth], [trust, trust])
        np.testing.assert_array_equal(bits, truth)
        # trust integer part counts agreeing qualified voters (the 2
        # slaves), fractional part the quorum (3 qualified voters)
        np.testing.assert_allclose(t, 2.3)

    def test_voteN_majority_corrects_errors(self):
        rng = np.random.RandomState(1)
        truth = rng.randint(0, 2, 2000).astype(np.int8)
        streams = []
        for i in range(3):
            b = truth.copy()
            flip = rng.rand(len(b)) < 0.02
            b[flip] ^= 1
            streams.append(b)
        trust = np.full(len(truth), 2, np.int8)
        bits, t = do_voteN(streams[0], trust, streams[1:], [trust] * 2)
        ber = np.mean(bits != truth)
        assert ber < 0.002, f"vote did not correct errors: BER {ber}"

    def test_voteN_distrust_disqualifies(self):
        truth = np.array([1, 1, 1, 1], np.int8)
        bad = np.array([0, 0, 0, 0], np.int8)
        good_t = np.full(4, 2, np.int8)
        bad_t = np.full(4, -1, np.int8)
        # two bad channels but disqualified -> truth wins
        bits, _ = do_voteN(truth, good_t, [bad, bad], [bad_t, bad_t])
        np.testing.assert_array_equal(bits, truth)


class TestAligner:
    def test_xcorr_finds_delay(self):
        rng = np.random.RandomState(2)
        truth = rng.randint(0, 2, 4000)
        delay = 1234
        stream = np.r_[rng.randint(0, 2, delay), truth]
        lag, ok = xcorr_peak(stream, truth, 15.0)
        assert ok
        assert lag == delay

    def test_random_bits_rejected(self):
        rng = np.random.RandomState(3)
        a = rng.randint(0, 2, 4000)
        b = rng.randint(0, 2, 2000)
        _, ok = xcorr_peak(a, b, 15.0)
        assert not ok


@pytest.fixture
def combiner_conf(bench_conf):
    conf = {k: v for k, v in bench_conf.items()}
    conf["SoftCombiner"] = dict(bench_conf["SoftCombiner"], processingInterval=0.15)
    conf["Interfaces"] = {
        "Internal": {
            "demodIn": "tcp://*:21003",
            "demodOut": "tcp://localhost:21003",
            "decodeOut": "tcp://localhost:21004",
            "decodeIn": "tcp://*:21004",
        }
    }
    return conf


class TestSoftCombinerProcess:
    """Process-level tests through real ZMQ sockets (reference
    test_softCombiner.py pattern): N logical channels are N streams
    into one combiner, no radios or accelerators needed."""

    def _run_streams(self, conf, streams, n_blocks=6, voteGroup=0):
        ctx = zmq.Context()
        out = ctx.socket(zmq.PUSH)
        out.connect(conf["Interfaces"]["Internal"]["demodOut"])
        sink = ctx.socket(zmq.PULL)
        sink.bind(conf["Interfaces"]["Internal"]["decodeIn"])
        sink.setsockopt(zmq.RCVTIMEO, 3000)

        comb = SoftCombiner(conf)
        comb.start()
        try:
            assert comb.ready.wait(20), "combiner did not come up"
            time.sleep(0.3)
            blocks = {k: np.array_split(v, n_blocks) for k, v in streams.items()}
            for i in range(n_blocks):
                for wid, chunks in blocks.items():
                    out.send_pyobj(wdict(wid, chunks[i], count=i, voteGroup=voteGroup))
                time.sleep(0.2)

            results = {}
            deadline = time.time() + 6
            while time.time() < deadline:
                try:
                    d = sink.recv_pyobj()
                except zmq.error.Again:
                    break
                results.setdefault(d["workerId"], []).append(d)
                got = {k: sum(len(x["data"]) for x in v) for k, v in results.items()}
                if len(results) == len(streams) and all(
                    n > len(streams[k]) * 0.5 for k, n in got.items()
                ):
                    break
            return results
        finally:
            comb.stop()
            comb.join(timeout=5)
            if comb.is_alive():
                comb.terminate()
            out.close()
            sink.close()
            ctx.term()

    def test_single_channel_passthrough(self, combiner_conf):
        rng = np.random.RandomState(5)
        truth = rng.randint(0, 2, 6000).astype(np.int8)
        res = self._run_streams(combiner_conf, {"chan0": truth})
        assert "chan0" in res
        got = np.concatenate([d["data"] for d in res["chan0"]])
        assert longest_match_run(got[: len(truth)], truth[: len(got)]) > 2000

    @pytest.mark.parametrize("n_chan", [2, 4, 6])
    def test_n_channel_vote(self, combiner_conf, n_chan):
        """Reference test_softCombiner.py exercises 2/3/4/6-way voting
        with random inter-channel delays and injected corruption."""
        rng = np.random.RandomState(40 + n_chan)
        truth = rng.randint(0, 2, 8000).astype(np.int8)
        # a 2-way vote resolves disagreements to the master (it cannot
        # correct), so its clean runs scale with 1/p; N>=3 corrects
        p_flip = 0.002 if n_chan == 2 else 0.01
        streams = {}
        for i in range(n_chan):
            delay = rng.randint(1000, 2000)
            b = np.r_[rng.randint(0, 2, delay), truth].astype(np.int8)
            b[rng.rand(len(b)) < p_flip] ^= 1
            streams[f"chan{i}"] = b
        res = self._run_streams(combiner_conf, streams)
        voted = [d for v in res.values() for d in v if d.get("numSlaves", 0) > 0]
        assert voted, f"no voting happened with {n_chan} channels"
        best = 0
        for d in voted:
            bits = np.asarray(d["data"], np.int8)
            lag, ok = xcorr_peak(np.r_[truth, np.zeros(4000, np.int8)], bits, 10.0)
            if ok:
                seg = truth[lag : lag + len(bits)]
                best = max(best, longest_match_run(bits[: len(seg)], seg))
        thr = 600 if n_chan == 2 else 1200
        assert best > thr, f"{n_chan}-way voted stream mismatch (best run {best})"

    def test_noise_only_channel_is_isolated(self, combiner_conf):
        """A channel carrying pure noise must not corrupt the others'
        voted output (reference :698-738 noise-channel cases)."""
        rng = np.random.RandomState(77)
        truth = rng.randint(0, 2, 8000).astype(np.int8)
        streams = {}
        for i in range(2):
            delay = rng.randint(1000, 2000)
            b = np.r_[rng.randint(0, 2, delay), truth].astype(np.int8)
            b[rng.rand(len(b)) < 0.002] ^= 1
            streams[f"chan{i}"] = b
        streams["noise"] = rng.randint(0, 2, 9500).astype(np.int8)

        res = self._run_streams(combiner_conf, streams)
        assert res, "no combiner output"
        best = 0
        for v in res.values():
            for d in v:
                bits = np.asarray(d["data"], np.int8)
                lag, ok = xcorr_peak(np.r_[truth, np.zeros(4000, np.int8)], bits, 10.0)
                if ok:
                    seg = truth[lag : lag + len(bits)]
                    best = max(best, longest_match_run(bits[: len(seg)], seg))
        assert best > 600, f"real channels corrupted by the noise channel ({best})"

    def test_three_channel_vote_corrects_corruption(self, combiner_conf):
        rng = np.random.RandomState(6)
        truth = rng.randint(0, 2, 9000).astype(np.int8)
        streams = {}
        for i in range(3):
            delay = rng.randint(1000, 2000)
            b = np.r_[rng.randint(0, 2, delay), truth].astype(np.int8)
            flip = rng.rand(len(b)) < 0.01
            b[flip] ^= 1
            streams[f"chan{i}"] = b
        res = self._run_streams(combiner_conf, streams)
        assert res, "no combiner output"
        # at least one master stream must have been voted (numSlaves>0)
        voted = [d for v in res.values() for d in v if d.get("numSlaves", 0) > 0]
        assert voted, "no voting happened"
        # a voted chunk must align with truth with long clean runs
        best = 0
        for d in voted:
            bits = np.asarray(d["data"], np.int8)
            lag, ok = xcorr_peak(np.r_[truth, np.zeros(4000, np.int8)], bits, 10.0)
            if not ok:
                continue
            seg = truth[lag : lag + len(bits)]
            best = max(best, longest_match_run(bits[: len(seg)], seg))
        assert best > 1500, f"voted stream does not match truth (best run {best})"

class TestSegmentedAlignment:
    """The beyond-reference per-segment alignment (combine/aligner.py
    BufferAligner + SoftCombiner.correlate): a bit slip between
    channels mid-window must not poison the vote past the slip, which
    is exactly what the reference's single whole-window lag does."""

    def _combiner(self, combiner_conf):
        comb = SoftCombiner(combiner_conf)  # never started: correlate only
        return comb

    def test_vote_survives_mid_window_slip(self, combiner_conf):
        rng = np.random.RandomState(9)
        n = 8000
        truth = rng.randint(0, 2, n).astype(np.int8)
        p = 0.02

        def corrupted():
            b = truth.copy()
            b[rng.rand(n) < p] ^= 1
            return b

        master = Worker(wdict("M", corrupted()))
        # both slaves slip inside segment [4000:6000): one drops a bit,
        # one gains a bit, so that segment fails the agreement gate for
        # both while every other segment realigns at its own lag
        a = np.delete(corrupted(), 4500)
        b = np.insert(corrupted(), 4600, rng.randint(0, 2))
        slaveA = Worker(wdict("A", np.r_[rng.randint(0, 2, 300), a]))
        slaveB = Worker(wdict("B", np.r_[rng.randint(0, 2, 150), b]))

        comb = self._combiner(combiner_conf)
        out = comb.correlate(master, [slaveA, slaveB])
        assert out is not None and out["numSlaves"] == 2

        voted = np.asarray(out["data"], np.int8)[:n]
        master_errs = int((wdict("M", truth)["data"] != truth).sum())  # 0 baseline
        voted_errs = int((voted != truth[: len(voted)]).sum())
        # master alone carries ~p*n = 160 errors; the 3-way vote corrects
        # them everywhere except the slipped segment (~2000 bits at p)
        assert voted_errs < 0.02 * n * 0.5, (
            f"vote did not correct past the slip: {voted_errs} errors"
        )

    def test_whole_window_tail_would_have_misvoted(self, combiner_conf):
        """Sanity: the slip actually breaks a single-lag alignment --
        agreement past the slip point is chance level."""
        rng = np.random.RandomState(11)
        n = 8000
        truth = rng.randint(0, 2, n).astype(np.int8)
        slipped = np.delete(truth, n // 2)
        lag, ok = xcorr_peak(slipped, truth, 10.0)
        if ok:
            tail = slipped[lag + n // 2 : lag + n - 1]
            agree = np.mean(tail == truth[n // 2 : n // 2 + len(tail)])
            assert agree < 0.6  # chance-level past the slip

    def test_pending_tail_held_for_lagging_slave(self, combiner_conf):
        """A slave that hasn't yet buffered the window tail causes the
        tail to be rolled back and re-voted next round."""
        rng = np.random.RandomState(12)
        n = 6000
        truth = rng.randint(0, 2, n).astype(np.int8)
        master = Worker(wdict("M", truth))
        # slave has only the first 2/3 of the stream so far
        slave = Worker(wdict("A", truth[: 2 * n // 3]))

        comb = self._combiner(combiner_conf)
        out = comb.correlate(master, [slave])
        assert out is not None and out["numSlaves"] == 1
        sent = len(out["data"])
        assert sent < n, "tail was not held back"

        # slave catches up; the held tail is re-served and voted
        slave.insertData(wdict("A", truth[2 * n // 3 :], count=1))
        out2 = comb.correlate(master, [slave])
        assert out2 is not None and out2["numSlaves"] == 1
        got = np.r_[np.asarray(out["data"]), np.asarray(out2["data"])]
        assert len(got) >= n
        assert np.array_equal(got[:n], truth)
