"""The port's prover against the JAX package's, on the toy circuits (CPU).

The K=6 toy circuit of tests/test_plonk_e2e.py (a vertical gate, a range
lookup and copy constraints) and its public-input circuit, copied here,
and a K=6 circuit with the two-column pair lookup of the SHA-256 chip.
The JAX package takes minutes on this CPU to key and prove them, so its
outputs under the deterministic `rng` below are stored here: the vk
transcript digest and the proof bytes. The port must reproduce both byte
for byte, on the default (v3) commit route, the serial one and the v1
one, and its verifier must accept the JAX proofs. The `slow` test
recomputes the stored values live from the JAX package and has the JAX
verifier accept the port's proofs. The same holds for the EVM route: GWC
and SHPLONK proofs over the Keccak transcript, stored under `keccak`.
"""
import functools
import hashlib

import numpy as np
import pytest
import torch

from webauthn_halo2_tpu_torch.fields.constants import BN254_FR
from webauthn_halo2_tpu_torch.fields.limbs import FR_SPEC
from webauthn_halo2_tpu_torch.plonk import cs as CS
from webauthn_halo2_tpu_torch.plonk.fused import FusedPhases
from webauthn_halo2_tpu_torch.plonk.keygen import keygen
from webauthn_halo2_tpu_torch.plonk.prover import create_proof
from webauthn_halo2_tpu_torch.plonk.srs import get_srs
from webauthn_halo2_tpu_torch.plonk.transcript import KeccakRead, KeccakWrite
from webauthn_halo2_tpu_torch.plonk.verifier import verify_proof

# The suite runs several test processes on one host (pytest-xdist); torch's
# default of one thread per core then oversubscribes it, and the small
# int64 ops of the plain kernels run several times slower.
torch.set_num_threads(2)

R = BN254_FR
K = 6

# JAX package outputs (keygen -> create_proof with _det_rng(seed)), K=6;
# `keccak`: the same with transcript=KeccakWrite(), per multiopen scheme
JAX_REF = {
    "toy": dict(
        seed=b"toy",
        transcript_repr=0xcad7f5dae38b87f3d49e24c37034a979cd5beea8fd3347fb1ac4ae1688bf34b,
        proof=(
        "74c8b2d7a22bdf06a8072e601ad059a54f967aa5b20b585ba02c97038fab7c0f"
        "98c5231f6bc70f67169895d913d67ce3dd2940a66e0560086641b96bef1e7a03"
        "866dabf79cee45e620434eb5f0c01e0a0324044b6c7180287b561af57c5fc794"
        "0dcb50fc3f1a1344a88f1fedaaa4b0ce0dfe886d1788f842018146317be71d9d"
        "7e6c4433b886ed14cc80253d6b319b4793a4a3f115e3b9716ba13ca919f538a1"
        "618cfe041a69f8c41aa09d31d77f477dafdb13ddc07325ea9244f4f08d776d22"
        "fddb6badfb84cbca7a86e3939b806313e4b9a68580fefebc3909b7dc0074119e"
        "579f864d4b9529dd43abe8eb70a4791cdf628c20fb33066693faa1b95ce30719"
        "89b439707754ba5ff1798b2082084d3a60db4e8e73f3886f8031e81e8303ac99"
        "d3cc763383b6fab9eaf38aa6af19c573fdfd5a7a418c0436fac2de1d87972212"
        "09483725723953ae050d535604f008ee79c022956c2ffc70aea9361293f65f1f"
        "0d159ec64244c5c2241c2408f20a5cb47e4fa670b2264aa1897e938637abe025"
        "1bc8246b429e91bb5298a7105d04f65aac3681176ff8d0a16185c36718174d17"
        "2d02cd0bed0ac118ba1ab905d9144274bb26cbe28242cd0ff7c9d69eadaea601"
        "0909dece379d305278e6a4c882a391c83e94a865901e935a575be455fa2a5c01"
        "5dcbce70b444fba2fdd8dec3cbb719b9909dcaca201fbdfb9dbf94bcb157840b"
        "ed9f3fb36bb7cc7441b507e866ee0209c5616aea75676ebfc8b1ff829557ee05"
        "9ec73550de036e17fcbeaddedd1862a6e90f766e4c1a78d95681bea38580262f"
        "c314146d25bae6284d03b45d17f63a8b09615a84fae81a4d1859cf652c344200"
        "f8b2435992b5437ef7827428e877e9293675c4e01b60c9b6b6429686b335870f"
        "6c56c71ee4f664adf32e4cb7a7c907d587560ca1e311e4f0f33c58f68f11a60e"
        "3447b3fbe796454c4bb745f4dcbfdf6cac97a6d5081d2c85248be163e3dc7c1b"
        "79625503aff05db1445c5fcce6f6a019a312b02ac157508fb396f860fed4dd09"
        "6e529a07390349321107cc187bc74b3b8f80fa26e4ef734353fac50a97819f1f"
        "f040f814cac0e643aa4fc21562badf1f533e5a2aead7a6dbd850aab857c49d1b"
        "89eb10584a1128ef17989eaa8679725b773fdd0fb486bb5cc6a6c28e7335b00f"
        "b45d27e90fe89cc71039bbf21c432c00041fed278b3544c94381d4504cbb452c"
        "0dbf9296d5340f0ec71090b5c9d3b0841a8a187131732d1f97181f80793a3f0b"
        "64cce99602686a19eedc5c3f371809292650d07811eb08327d3499c68410031c"
    ),
        keccak=dict(
            gwc=(
            "0f7cab8f03972ca05b580bb2a57a964fa559d01a602e07a806df2ba2d7b2c874"
            "1788b4b020d91ee97d5319aa156e521bf1f6d24f31ad16dee95ee9e1bf924ce2"
            "037a1eef6bb941660860056ea64029dde37cd613d9959816670fc76b1f23c598"
            "03e16da5aa33947d1bd77e63e86fb7d8bf74dbaca6dfbfd15b96b2e051950a3e"
            "14c75f7cf51a567b2880716c4b0424030a1ec0f0b54e4320e645ee9cf7ab6d86"
            "3020f9c37af3fcc9891a62296bfeb3513db7d56dbd6de67134d655ba6295f3e5"
            "1d1de77b3146810142f888176d88fe0dceb0a4aaed1f8fa844131a3ffc50cb0d"
            "0b5249e74d071746d09d7305f6f0ad5045c566076a326a4ac8332518ab745e63"
            "0b29118a63d035269b1698fe23f45349c1eb19ecdd20e2dfc0a9baae71e2dd0b"
            "10997d6c1fa5e97f6456a9e2df8ba19037befd2c0a74ed14c6d5285470b4e7a2"
            "262dde120cc586c7e4241670cec2f58023a334f9ac28d10cd603bec74035c4dd"
            "0e21f023586e80a21656bfbcd285239bd28a04109dae5c5a53ad0b348c7ff5be"
            "1e117400dcb70939bcfefe8085a6b9e41363809b93e3867acacb84fbad6bdbfd"
            "036dd9cb437a41cba0a44cc5e90a81b449161fa888483e77987e476bd21bebc3"
            "1ae107289f23a7d32414b9769fa69994919535498834290062816a7257f79052"
            "2d93977214602e02f36dd8ca945b9689bbf6d65675268c4278bfac9f826d1380"
            "058e9b3139533386fd619d082273f7c5e2a94d8624ec26a0bb499a3d754be151"
            "292b615303573fce59dbc5ab41a5c2ae9565f776566c3ad77fe2f07bede32cc7"
            "11739918ad0ed2035abd35f95efd9bc51e0f0e664fe2ab04311ce73273ddcc38"
            "0c402f51a73c3ae2d395daadd54c7a31f741d174695141497ab0e34c813f5e05"
            "1656918fabff4b9b17caaa0170a13155692f86832181733de98002ff0261eb22"
            "003b7328e99b3c71fa2727f10b2f027d3bf5129471ae5afc8f45a04289218a9e"
            "029a61ff9c2fae67c6a3925be3e0f1cd1355b76d9b276e1f8ebd3b13e1c4bbdf"
            "0ada68d42464886d44cb0edfada4b66f11b5dc7fcad1885b25ce343791049a98"
            "02e9410690ac7b3d9de3cb919bb50ac6ee9c0e7cff488a54d2b3417ebf23b411"
            "11772c3ae6c2dc316e93694201805f7a32482066c84bc76ee0433d5291a304c8"
            "0738159561ad24718900b56da3904404457decbdd7b06a7d9f7b85859aa2a944"
            "11c26ee18f84f31f070b8138cbdc87da5c56b5cc3702b5082f98a3b426996389"
            "24a018bda568cbd5ad086b3a493a3061d1e2d9f7ee72c3fbd0b707af80e0341c"
            "112aa2ef3dd7e92c1d563f39f14310ec25556a2f1c2eb0c496257c3e82f2472d"
            "238ce50891f84d1fccee79d9d7a7a622cf01daffb524657e3013c67526da7e4a"
            "280b11ae336d5fc9c71cbd61346549f0b8690293e69cf2fc1d4f356f92819570"
            "0ea00d8689eaeb2e1c593536588e04d52b4f2abd13785e7d0c4825ae2a8c8d2b"
            "26e120c51f832312317104e4fcb1123788b68869688f4309b2c9be15d4bc12bd"
            "2f6e346f0c3d29ef6c30d143719a2703c66eaa62a815a171a17af3c0973748ac"
            "051d616b118118a4f320009b903619a73bd7188d078d3224a65678bcb0568c30"
            "280b73e3e68cfdf835972504c728d9a17760ee91ab22f25b287ae344a8419780"
            "2d768b86cc6f83d28c35cb0b20a542991709ce43295fcc622445c460c6cffe8b"
            "0a3ba5b3243401bfbb0d38e33727c509c9456208b51e7f9a034f8d6f77e98de6"
            "0929f2ca709befcfbf8a37ff306fee4a87421ae9c089a6ed806ec012f5e938d2"
            "2c19bea8e11ac85aa359df7aff6affc90e518d4ac0a9005e801d4353ab241f71"
            "113867e30673514e3ecbb1c6e536aeb3ed3bbff0dc2064aeab0f33204a7a2996"
            "24c5b111d13331720f77d424467277d17d6258d447a246f9f541340490776d4c"
            "16bc872942237abfb94cb85b8b8267c51fdafaa72ede000d9efc3b05287e3e3f"
            "0c386f8a7ea5a1d404aa7c815f7b298567c80c02cd937591449430416ac35f64"
            "1d50622578767707738ef28509015ceab5452c0feb84020e18245c065474cc7d"
            "1a08382c4e8cf577b647c1bc16d99845de819808a340000ddf537905109b252b"
            ),
            shplonk=(
            "0f7cab8f03972ca05b580bb2a57a964fa559d01a602e07a806df2ba2d7b2c874"
            "1788b4b020d91ee97d5319aa156e521bf1f6d24f31ad16dee95ee9e1bf924ce2"
            "037a1eef6bb941660860056ea64029dde37cd613d9959816670fc76b1f23c598"
            "03e16da5aa33947d1bd77e63e86fb7d8bf74dbaca6dfbfd15b96b2e051950a3e"
            "14c75f7cf51a567b2880716c4b0424030a1ec0f0b54e4320e645ee9cf7ab6d86"
            "3020f9c37af3fcc9891a62296bfeb3513db7d56dbd6de67134d655ba6295f3e5"
            "1d1de77b3146810142f888176d88fe0dceb0a4aaed1f8fa844131a3ffc50cb0d"
            "0b5249e74d071746d09d7305f6f0ad5045c566076a326a4ac8332518ab745e63"
            "0b29118a63d035269b1698fe23f45349c1eb19ecdd20e2dfc0a9baae71e2dd0b"
            "10997d6c1fa5e97f6456a9e2df8ba19037befd2c0a74ed14c6d5285470b4e7a2"
            "262dde120cc586c7e4241670cec2f58023a334f9ac28d10cd603bec74035c4dd"
            "0e21f023586e80a21656bfbcd285239bd28a04109dae5c5a53ad0b348c7ff5be"
            "1e117400dcb70939bcfefe8085a6b9e41363809b93e3867acacb84fbad6bdbfd"
            "036dd9cb437a41cba0a44cc5e90a81b449161fa888483e77987e476bd21bebc3"
            "1ae107289f23a7d32414b9769fa69994919535498834290062816a7257f79052"
            "2d93977214602e02f36dd8ca945b9689bbf6d65675268c4278bfac9f826d1380"
            "058e9b3139533386fd619d082273f7c5e2a94d8624ec26a0bb499a3d754be151"
            "292b615303573fce59dbc5ab41a5c2ae9565f776566c3ad77fe2f07bede32cc7"
            "11739918ad0ed2035abd35f95efd9bc51e0f0e664fe2ab04311ce73273ddcc38"
            "0c402f51a73c3ae2d395daadd54c7a31f741d174695141497ab0e34c813f5e05"
            "1656918fabff4b9b17caaa0170a13155692f86832181733de98002ff0261eb22"
            "003b7328e99b3c71fa2727f10b2f027d3bf5129471ae5afc8f45a04289218a9e"
            "029a61ff9c2fae67c6a3925be3e0f1cd1355b76d9b276e1f8ebd3b13e1c4bbdf"
            "0ada68d42464886d44cb0edfada4b66f11b5dc7fcad1885b25ce343791049a98"
            "02e9410690ac7b3d9de3cb919bb50ac6ee9c0e7cff488a54d2b3417ebf23b411"
            "11772c3ae6c2dc316e93694201805f7a32482066c84bc76ee0433d5291a304c8"
            "0738159561ad24718900b56da3904404457decbdd7b06a7d9f7b85859aa2a944"
            "11c26ee18f84f31f070b8138cbdc87da5c56b5cc3702b5082f98a3b426996389"
            "24a018bda568cbd5ad086b3a493a3061d1e2d9f7ee72c3fbd0b707af80e0341c"
            "112aa2ef3dd7e92c1d563f39f14310ec25556a2f1c2eb0c496257c3e82f2472d"
            "238ce50891f84d1fccee79d9d7a7a622cf01daffb524657e3013c67526da7e4a"
            "280b11ae336d5fc9c71cbd61346549f0b8690293e69cf2fc1d4f356f92819570"
            "0ea00d8689eaeb2e1c593536588e04d52b4f2abd13785e7d0c4825ae2a8c8d2b"
            "26e120c51f832312317104e4fcb1123788b68869688f4309b2c9be15d4bc12bd"
            "2f6e346f0c3d29ef6c30d143719a2703c66eaa62a815a171a17af3c0973748ac"
            "051d616b118118a4f320009b903619a73bd7188d078d3224a65678bcb0568c30"
            "280b73e3e68cfdf835972504c728d9a17760ee91ab22f25b287ae344a8419780"
            "03e3212565987bb77a29e15837aece0c5ee47024b98eaca0cca48434a70c2e67"
            "0220758124e0d4cca8a101bf1d7cc46c0fe8e6516093699606b04f9d987705ab"
            "11d8c500a127c953647770dac2b6481937460c05addb6250f49ff8309bec53da"
            "2956526ee2ef8b863d6607f2e0aa42059b0f6d5fb1b4367eeae6ebbca7016312"
            ),
        ),
    ),
    "pub": dict(
        seed=b"pub",
        transcript_repr=0x51414d552ad4fafea41251f3737d0701de16a6b35594fb04187a6675099c12f,
        proof=(
        "73f3f7c3eabf2adf01a5cf3c251f6a09e72a63cbf976cb5687c71f761df1678e"
        "f478ba6fe5b5e25ad5e31954e0fad0b0222c80d071ba8a4977a24d0ff1a41788"
        "e6dfa0465d57cd6cb8632d61389bd3f02c6f6c9fc6e6b734eea81ad5a00c7c89"
        "a90f44f24e8685b6d153a62445514165bb852261b7a74e5391dc48570322a728"
        "da54626b01bf88790b6a73510fce5a8c4fdffaa4a1a97362676267bcf74b101f"
        "23fcb2ca22310a1c8652fdbd4ed5bc8518ca445817ccd4869457ddf6c9259821"
        "f64e1eafb990b232dff927b626d7b2ac6933f0ce1c9548df1e032356f8ebb205"
        "5e3869d6f560b7655472d05584b9650f037b02e637ab3c8b19c80401b1725318"
        "5e3869d6f560b7655472d05584b9650f037b02e637ab3c8b19c80401b1725318"
    ),
        keccak=dict(
            gwc=(
            "0e67f11d761fc78756cb76f9cb632ae7096a1f253ccfa501df2abfeac3f7f373"
            "03915107b3dd86fc46a36b1fd1a1a0137b51b3f97e7dcc094364c4ef27a2513b"
            "0817a4f10f4da277498aba71d0802c22b0d0fae05419e3d55ae2b5e56fba78f4"
            "24c15d2689ed199c87c2b78cadab4ceea7683ff507afa85f7b3f4903752d85a3"
            "097c0ca0d51aa8ee34b7e6c69f6c6f2cf0d39b38612d63b86ccd575d46a0dfe6"
            "13f28d3072ecf86d36214b16cf88b9ff51eec432a0e383262ea3c75f8c8a965f"
            "21776992d849b845f1afdca9ab6cff8cc25359aafb8ea7dbe2bd7a39d2a3329e"
            "2a85227ca9aeed50b28baaf61299d31e390f04b2fcd16cf0e9a78e4a8d820deb"
            "19161f11f99729c138d6af33bec04595738ec142944c163cd0692ef22f5ff770"
            "0dafeca71f36864d0b5167516341e6b7146e8622872464c98762aea5c1b1a11c"
            "1e941c9fbab27590cd9e7c889aaca12acbbe8d2ed9b27c1cbc755357cd5cd943"
            "1e0b0d6ff0e094dce2efec8808a69975596a2bed2211cf965984bd618c29b255"
            ),
            shplonk=(
            "0e67f11d761fc78756cb76f9cb632ae7096a1f253ccfa501df2abfeac3f7f373"
            "03915107b3dd86fc46a36b1fd1a1a0137b51b3f97e7dcc094364c4ef27a2513b"
            "0817a4f10f4da277498aba71d0802c22b0d0fae05419e3d55ae2b5e56fba78f4"
            "24c15d2689ed199c87c2b78cadab4ceea7683ff507afa85f7b3f4903752d85a3"
            "097c0ca0d51aa8ee34b7e6c69f6c6f2cf0d39b38612d63b86ccd575d46a0dfe6"
            "13f28d3072ecf86d36214b16cf88b9ff51eec432a0e383262ea3c75f8c8a965f"
            "21776992d849b845f1afdca9ab6cff8cc25359aafb8ea7dbe2bd7a39d2a3329e"
            "2a85227ca9aeed50b28baaf61299d31e390f04b2fcd16cf0e9a78e4a8d820deb"
            "19161f11f99729c138d6af33bec04595738ec142944c163cd0692ef22f5ff770"
            "0dafeca71f36864d0b5167516341e6b7146e8622872464c98762aea5c1b1a11c"
            "0c044440e1e6ede7d80223d39357299de647b55916d9010c1155982cea549cf5"
            "2c470529cbfd2f1218da2f0bc49cdcbdc00ed1f1de6bdd9773f8c6e4a19978b3"
            "0c044440e1e6ede7d80223d39357299de647b55916d9010c1155982cea549cf5"
            "2c470529cbfd2f1218da2f0bc49cdcbdc00ed1f1de6bdd9773f8c6e4a19978b3"
            ),
        ),
    ),
    "pair": dict(
        seed=b"pair",
        transcript_repr=0x103eeab849bfbf113d684399beb3feaeb11642ed4a5a41115330c40b02822ecb,
        proof=(
        "ad9016b214af282b9be88762d44322273ff1291716ef5424e42942acfd1a230f"
        "467880cefd432388b99b0256cb7ad5122d70bfabacf80a111272d509e4d85a92"
        "c65793df5ddcc539e5eb01ab8784f4008ae0c9ce6eba55c1ab4da1a1a35d9e02"
        "d9432363e91bc6647bde99aa3a7fe58d953ad89a1de471458250dadb57c15e1d"
        "1b52caf377d559fc5df1df30d95faed9e9e77ba2d6aa93073bdc3a72c81350a0"
        "30c9f3005b1e65ca2391f6b21307abc6615f39ab35446b6252fd1766a3fe640c"
        "375e87d0fea063047f0dee3eba9aabe1892dc4a9ff979a0532857e93afed899f"
        "4476d5118c979b7ffc286325230e50ff0bb762b249d3f8f7f944639f5fe78f07"
        "60d5e66b34696daaa68ff362ddda2bec8c168525e92b069ce57967b7493afd0b"
        "33c21a67d4ed64913c902436ab7e02056830fbfd71a059688fd053b3583cdc0b"
        "4afbfbba6ae9ad44d7bce86167524c125bb1d1a3ceb23b2c790e72d2f10b91a4"
        "2039074c93b80c6f35c6c328b3e9ea96ad0e76c56f33c5bb013916e3ec64479e"
        "6f97d69d3584d241b2f558f8da7fe31663a32b52177713675edbd217873f6817"
        "a3e2437ba38ef1d689149db2696840090ac0e313cdd2034c5fd61250fc72790a"
        "79f7248e3612b9b90cc53eb0f6a5792708c69ed48dacc6f3d3ed1269fa65bd22"
        "d64a9bccf94b43186a651d4cb0eb8fdc9f1b9b4ef93e19bfbba38ef794038c16"
        "1642523c9c6644d40b07b8122870b4e9d5653f8e543a5c16281a24556307812d"
        "090b7af2051f530e1565ac35f849d26b7f6d1fe2991092d41f8b46d0e0243a13"
        "7893dbc9d5f150ca76c239aef7183bb0a3f320f0e6dfa23101c81f60b891120f"
        "02675555e14cd3f1a0d06d293c31a1b2b77d0659dab67e6dcdc893a37409c20b"
        "4a4c2ac15f6e3507626c1d5c7b5f297cf9560f83ba6f2fcd7b297990c3a13321"
        "497bf8567ae8957df1477810eefa6886b70afde670d9a11567329fe970406c2d"
        "7eaf05cca5d3711cf99eeaa568f389b3d0ca60bd01812bec01b9f5532f3a291d"
        "32a30407024a710857abebd3d129a7668621869cb08595a1868316a3176ad91a"
        "cbd746708e384e76fe37ac510e988e8713b639630512acb5ee45d920dea2870e"
        "c41f3937ad804c23474b7b3c77d367d13639b868fae874c18fa99a2f1248b222"
        "350485bc06527f40837284ef1a9832d00cd90d739367ef221bba2d9d33f39f06"
        "ce5cfcb362c408e01c258997fee7f1accb28699b386ee64fb25214ed71ccdc01"
        "7181cc79248cbd07e9f597003feeac164820f049d2228dc35c91822d8f95471e"
        "1a3fa4815918bbad939f5538a192b4e8a6421bcce494bc7f7a1bac8247ca3d26"
        "7c7ef8dbc438252b6ce2171636e9c14de8a6128f6180201c6007fc2de1121a0a"
        "3b7e661872a8d2577761e5cba7a7a58591d639eaa031d9c44aa85c5e000b9f09"
        "4b1175beae54276b455ab3ff76060bcfe0f6ca69defd04a7ce8b31a6c1580f07"
        "7cfcda2cfc7741fcab14f01af32a7b7d12c4a2e5d1d4cec6bed60294659fb827"
        "cb5447517eb17f4e393882306ebddb38081de4baed0adc1b1befc838a261560f"
        "e6f6011f783ef569ec43ec0bfa0b7a07bb4285c4fd749978b4d4a9db2c5aad28"
        "e27fdd554e951ef3e6c0695693c0dd4905d7b68990bd0e28d81a7301e48c848c"
    ),
        keccak=dict(
            gwc=(
            "0f231afdac4229e42454ef161729f13f272243d46287e89b2b28af14b21690ad"
            "2ee5e92f30b3d0aad2848ced4f79e86a6fae75413c598b8a11551ccd57b9b516"
            "125ad8e409d57212110af8acabbf702d12d57acb56029bb9882343fdce807846"
            "211fb5f90b1f2c884fe47f7b6c6e1344835d57a1483c918e29cc36b3569bd8b1"
            "029e5da3a1a14dabc155ba6ecec9e08a00f48487ab01ebe539c5dc5ddf9357c6"
            "12665b2997e0952e878430cc83ec7cabee6e7c5d7aff2f554945c885d89058bc"
            "2763991b19486668738e7395da0bcbfc1aabd2c0842571f06844aa5fdbae0e71"
            "0d0191fb40810ece741d24b09c35062a22f2f76afe62d2c51a5db9c53d80bf8f"
            "0647fec1049e78d92053d8329af4b655bd0ec213cd738ec9a5554fd0c97a8578"
            "27ff46d31a6305331e01558f81f466231fda760ae4ab8ee99ee207325a779b7e"
            "239bb776472bcb95e6ceadd5d068060846b3bb7e065f1f5f9e601bcb70ed6876"
            "00ff1f00c5446c0ff039a8cb9837b878e5d8def8285594f8952f55bdb7dbfa02"
            "192eee442711a8f2081759525bf4780e668ec6b3569cfb059765f058d515a7bc"
            "0f7a3eeaeddcd17499a216fc74d47e931563a8fe10982fdcaae4edd10b4a3608"
            "07f0a63f275955dc41253ce6883d177bab4d56d2c71b15661eab65d253b5e53b"
            "0777e1bce5d7d51f7445ceb3a24fb7e0df0df4b9fde9845ec07f1f6d6da9a3dd"
            "0bfd3a49b76779e59c062be92585168cec2bdadd62f38fa6aa6d69346be6d560"
            "0879e7c80ffac9ccf238f3890315c30a9f5deaafd93be0f00fbf0d0d2374b5a4"
            "2d54da22057f6c0441d857d33e6740a021fa83bfbdce37b9ddd3c4ce0a8e99c9"
            "0538d0736d5835e9244f9d85d72115466aec721a5c53a7bdddaa45e15ae308bf"
            "08d1efd244cbea0bd7b87d501bf03be0d3ce8fdc276f5ba6d38d8fd82535a36b"
            "096fc351464687d7ac97e89cf6acf84418eeca0d8a72ac5f600f46a7e5dd1640"
            "0e5bf52e3974c513fb19a2fefe9b4516b96aaa6387f8102039506483af51a8ed"
            "1b32d37b160d35a6cf3c894745bfbc53fe24a9f3e1e9839dd8f786a1d095f9b0"
            "1d8758266ec9ce92983e23d1a0a6a060d779c726b41261891ac7f6b547eee0dc"
            "221e224ff5750e45dac2e2b760d4153f0870d1a3b72936d9dad00df448977b7c"
            "0861ca6a2ac21a394e7441b934804ea8abb289e1af3a47c5daab279ecdce2279"
            "0d59c6f845accf2c8074cf5c25ea0f8904ec8bb3e753549217bba0a84b3bb8d7"
            "071fbaa801ebbaf8707fc9669e40238368c3a7a43ced5342204f63ee2770aacb"
            "0f7ceb816eb09bc499d9de75739c5a098709c48d66207627280494727d307d82"
            "08d79433ee380262287796adf2cb46b127ba0f6bc1110d7fd44b72a2175de5bc"
            "1c0a1ef6e1216b8c00d235b6d41237afe8e04de18a17aa8598402d11f0104cf0"
            "27de410aa138c38e989a7ee83a649b60e06a3abcf2335166064f4e58e0ccb2a0"
            "175f6b26dee6be2c7bfe083e190fbcb8b17a3cc3a1c90705806fd43984794b3d"
            "17eb01dfa49aa0568bd990a0d066ad42eb4bfd34472ad0c28632994befd54fc6"
            "0345b16a81c8701a56fff4536572caff5d5f04a2e4c9e7f30705a374170a6b01"
            "2a2f9a96c2476ae69cc936bbbb4362103bb6ae64420588532da4c21365064700"
            "187688af460515952009f4d2adcd9b45b4dfae65307c60f15b7af6f4d8a98eae"
            "1d1fb426d5bc360a4c5daf34d0304fd7239ee746e18c0f674ab8a45c81c388e5"
            "032611df0dd952029c8ff5df7084eebc99649d2d7d3b697eef22c58879e7941a"
            "2a1d97d14942c280bed3283a18fc39a7b84bef200fb85db643ea468343a6053d"
            "04185a9160a8c826739b5b451b21a41d488f2275408150680c2cc9103ace870d"
            "0ea72fef73f14b6bc7272206bcbad1186d18e7fa2444e3aaa2bc54d9110b0aad"
            "23bf9799f5154ae53219475ff510ee1408ee04dd43589c139701a619c102ba98"
            "244a7a6d3f5e66c3650a1c20d1cced87871e127613e6842f0d3cda4cea6c9d23"
            "1ab2f3092718d1bf464b288e150951299a99a3e0480fac3e5e5f117d4e882ba0"
            "07a7f6057d8f1f38d164b488f61c9f0f7d25482859c5922919f098144fc0be35"
            "1d56bcde3232e65e3444664b6faaa1a6e4d39b7e3666424fd8f597c706246f33"
            "01b47da86cc659029ef6ad2384365eda2e56b5f631077cdd532e218198420271"
            "195c86a7fa4c57152c1594fed614a0123ebb4969a699babcbafbc10c39c19ba5"
            "158860733f61608a88c0c1f366a13a28e8daa5ad6ed4ebcf4721804d44ea1136"
            "0623d3a40f18894d948737ddad21187561befba00ff770d5f2d1b9dd621368cb"
            "0ea181664d9e35589437166d853c0c8478cca7762bc9173e7fa6715421f4fea8"
            "2613742b5463bdfd38edaea79c1db3ba8bb185bd118e1417e754e1ebf40550f9"
            "2569884205cf4f8e8f9a6c9ed0695b2bef545ade987a82196be3e0c6638a198a"
            "2e3724208818339d10c06185218da86ed83a73af73d4c4d8919b5942b1730cb2"
            "0ddb29db965367b7f052f8ea987253387b62a6fcb32d563b1fa4791b0aceafd9"
            "05c8c37f39bb42af85c1a28f3dffebe12c9693439ec92f4ad34141bc3b9912e7"
            "053c708cea56625b658f2956f6210193733d241178615db964698751228bc674"
            ),
            shplonk=(
            "0f231afdac4229e42454ef161729f13f272243d46287e89b2b28af14b21690ad"
            "2ee5e92f30b3d0aad2848ced4f79e86a6fae75413c598b8a11551ccd57b9b516"
            "125ad8e409d57212110af8acabbf702d12d57acb56029bb9882343fdce807846"
            "211fb5f90b1f2c884fe47f7b6c6e1344835d57a1483c918e29cc36b3569bd8b1"
            "029e5da3a1a14dabc155ba6ecec9e08a00f48487ab01ebe539c5dc5ddf9357c6"
            "12665b2997e0952e878430cc83ec7cabee6e7c5d7aff2f554945c885d89058bc"
            "2763991b19486668738e7395da0bcbfc1aabd2c0842571f06844aa5fdbae0e71"
            "0d0191fb40810ece741d24b09c35062a22f2f76afe62d2c51a5db9c53d80bf8f"
            "0647fec1049e78d92053d8329af4b655bd0ec213cd738ec9a5554fd0c97a8578"
            "27ff46d31a6305331e01558f81f466231fda760ae4ab8ee99ee207325a779b7e"
            "239bb776472bcb95e6ceadd5d068060846b3bb7e065f1f5f9e601bcb70ed6876"
            "00ff1f00c5446c0ff039a8cb9837b878e5d8def8285594f8952f55bdb7dbfa02"
            "192eee442711a8f2081759525bf4780e668ec6b3569cfb059765f058d515a7bc"
            "0f7a3eeaeddcd17499a216fc74d47e931563a8fe10982fdcaae4edd10b4a3608"
            "07f0a63f275955dc41253ce6883d177bab4d56d2c71b15661eab65d253b5e53b"
            "0777e1bce5d7d51f7445ceb3a24fb7e0df0df4b9fde9845ec07f1f6d6da9a3dd"
            "0bfd3a49b76779e59c062be92585168cec2bdadd62f38fa6aa6d69346be6d560"
            "0879e7c80ffac9ccf238f3890315c30a9f5deaafd93be0f00fbf0d0d2374b5a4"
            "2d54da22057f6c0441d857d33e6740a021fa83bfbdce37b9ddd3c4ce0a8e99c9"
            "0538d0736d5835e9244f9d85d72115466aec721a5c53a7bdddaa45e15ae308bf"
            "08d1efd244cbea0bd7b87d501bf03be0d3ce8fdc276f5ba6d38d8fd82535a36b"
            "096fc351464687d7ac97e89cf6acf84418eeca0d8a72ac5f600f46a7e5dd1640"
            "0e5bf52e3974c513fb19a2fefe9b4516b96aaa6387f8102039506483af51a8ed"
            "1b32d37b160d35a6cf3c894745bfbc53fe24a9f3e1e9839dd8f786a1d095f9b0"
            "1d8758266ec9ce92983e23d1a0a6a060d779c726b41261891ac7f6b547eee0dc"
            "221e224ff5750e45dac2e2b760d4153f0870d1a3b72936d9dad00df448977b7c"
            "0861ca6a2ac21a394e7441b934804ea8abb289e1af3a47c5daab279ecdce2279"
            "0d59c6f845accf2c8074cf5c25ea0f8904ec8bb3e753549217bba0a84b3bb8d7"
            "071fbaa801ebbaf8707fc9669e40238368c3a7a43ced5342204f63ee2770aacb"
            "0f7ceb816eb09bc499d9de75739c5a098709c48d66207627280494727d307d82"
            "08d79433ee380262287796adf2cb46b127ba0f6bc1110d7fd44b72a2175de5bc"
            "1c0a1ef6e1216b8c00d235b6d41237afe8e04de18a17aa8598402d11f0104cf0"
            "27de410aa138c38e989a7ee83a649b60e06a3abcf2335166064f4e58e0ccb2a0"
            "175f6b26dee6be2c7bfe083e190fbcb8b17a3cc3a1c90705806fd43984794b3d"
            "17eb01dfa49aa0568bd990a0d066ad42eb4bfd34472ad0c28632994befd54fc6"
            "0345b16a81c8701a56fff4536572caff5d5f04a2e4c9e7f30705a374170a6b01"
            "2a2f9a96c2476ae69cc936bbbb4362103bb6ae64420588532da4c21365064700"
            "187688af460515952009f4d2adcd9b45b4dfae65307c60f15b7af6f4d8a98eae"
            "1d1fb426d5bc360a4c5daf34d0304fd7239ee746e18c0f674ab8a45c81c388e5"
            "032611df0dd952029c8ff5df7084eebc99649d2d7d3b697eef22c58879e7941a"
            "2a1d97d14942c280bed3283a18fc39a7b84bef200fb85db643ea468343a6053d"
            "04185a9160a8c826739b5b451b21a41d488f2275408150680c2cc9103ace870d"
            "0ea72fef73f14b6bc7272206bcbad1186d18e7fa2444e3aaa2bc54d9110b0aad"
            "23bf9799f5154ae53219475ff510ee1408ee04dd43589c139701a619c102ba98"
            "244a7a6d3f5e66c3650a1c20d1cced87871e127613e6842f0d3cda4cea6c9d23"
            "1ab2f3092718d1bf464b288e150951299a99a3e0480fac3e5e5f117d4e882ba0"
            "07a7f6057d8f1f38d164b488f61c9f0f7d25482859c5922919f098144fc0be35"
            "2dbe9036564dccf56c93a2332fec833bbc54847cfd84fa128e6d3e8da18ffc1b"
            "171043a68638c6a4dbcd9ba59b5430cd162d0a3761edabc9fb908ba01a7db8b6"
            "23b33395645d89e6c6caec41da25730c0e2a439f21fd7c0382318487cb1bbb54"
            "27fea663218d5da421668889784453a9578197143f92045d95873217bcd43163"
            ),
        ),
    ),
}


def _det_rng(seed: bytes):
    """rng(nbytes) -> bytes: blake2b of the seed and a call counter."""
    ctr = [0]

    def rng(nbytes: int) -> bytes:
        ctr[0] += 1
        return hashlib.blake2b(seed + ctr[0].to_bytes(8, "little"),
                               digest_size=nbytes).digest()

    return rng


def build_toy(cs_mod):
    """fixed0 = q (gate selector), fixed1 = table; advice0 = gate column,
    advice1 = lookup input column (tests/test_plonk_e2e.py:24-37)."""
    cs = cs_mod.ConstraintSystem(num_fixed=2, num_advice=2)
    q = cs_mod.fixed(0)
    cs.gate("vgate", q * (cs_mod.advice(0, 0) + cs_mod.advice(0, 1) * cs_mod.advice(0, 2)
                          - cs_mod.advice(0, 3)))
    cs.lookup("range8", [cs_mod.advice(1)], [cs_mod.fixed(1)])
    cs.enable_permutation(cs_mod.ADVICE, 0)
    cs.enable_permutation(cs_mod.ADVICE, 1)
    return cs


def toy_inputs(cs_mod):
    """(cs, fixed, advice, instances, copies) of the toy circuit
    (tests/test_plonk_e2e.py:40-57)."""
    cs = build_toy(cs_mod)
    n = 1 << K
    usable = cs.usable_rows(n)
    a0, b0, c0 = 3, 5, 7
    d0 = (a0 + b0 * c0) % R
    b1, c1 = 2, 4
    d1 = (d0 + b1 * c1) % R
    adv0 = [a0, b0, c0, d0, d0, b1, c1, d1] + [0] * (usable - 8)
    adv1 = [1, 6, 5, 7, 0, 2] + [0] * (usable - 6)
    q = [1, 0, 0, 0, 1, 0, 0, 0] + [0] * (n - 8)
    table = [i for i in range(8)] + [0] * (n - 8)
    copies = [
        ((cs_mod.ADVICE, 0, 3), (cs_mod.ADVICE, 0, 4)),
        ((cs_mod.ADVICE, 0, 1), (cs_mod.ADVICE, 1, 2)),
    ]
    return cs, [q, table], [adv0, adv1], [], copies


def pub_inputs(cs_mod):
    """The public-input circuit of tests/test_plonk_e2e.py:127-150."""
    cs = cs_mod.ConstraintSystem(num_fixed=1, num_advice=1, num_instance=1)
    cs.gate("pub", cs_mod.fixed(0) * (cs_mod.advice(0) - cs_mod.instance(0)))
    n = 1 << K
    usable = cs.usable_rows(n)
    adv = [42, 99] + [0] * (usable - 2)
    qcol = [1, 1] + [0] * (n - 2)
    return cs, [qcol], [adv], [[42, 99]], []


def pair_inputs(cs_mod):
    """The shape of circuits/builder.py's pair tables (the SHA-256 chip's
    XOR and AND lookups) at K=6: a two-column lookup of (key, value)
    advice columns into (key, value) fixed columns, a 16-row table
    (key = x + 4y, value = x ^ y for 2-bit x, y) zero-padded, so that the
    padding rows compress to the table's row (0, 0), and copies from the
    gate column into both lookup columns. Three permutation columns make
    two carry-chained permutation chunks."""
    cs = cs_mod.ConstraintSystem(num_fixed=3, num_advice=3)
    cs.gate("vgate", cs_mod.fixed(0) * (cs_mod.advice(0, 0) + cs_mod.advice(0, 1)
                                        * cs_mod.advice(0, 2) - cs_mod.advice(0, 3)))
    cs.lookup("pair", [cs_mod.advice(1), cs_mod.advice(2)], [cs_mod.fixed(1), cs_mod.fixed(2)])
    for i in range(3):
        cs.enable_permutation(cs_mod.ADVICE, i)
    n = 1 << K
    usable = cs.usable_rows(n)
    # two gates key = x + 4 * y: (x, y) = (3, 2) and (1, 3), then the values
    adv0 = [3, 4, 2, 11, 1, 4, 3, 13, 3 ^ 2, 1 ^ 3] + [0] * (usable - 10)
    keys = [11, 13, 5, 11, 15] + [0] * (usable - 5)
    vals = [3 ^ 2, 1 ^ 3, 1 ^ 1, 3 ^ 2, 3 ^ 3] + [0] * (usable - 5)
    q = [1, 0, 0, 0, 1, 0, 0, 0] + [0] * (n - 8)
    tkeys = list(range(16)) + [0] * (n - 16)
    tvals = [(i & 3) ^ (i >> 2) for i in range(16)] + [0] * (n - 16)
    copies = [
        ((cs_mod.ADVICE, 0, 3), (cs_mod.ADVICE, 1, 0)),
        ((cs_mod.ADVICE, 0, 7), (cs_mod.ADVICE, 1, 1)),
        ((cs_mod.ADVICE, 0, 8), (cs_mod.ADVICE, 2, 0)),
        ((cs_mod.ADVICE, 0, 9), (cs_mod.ADVICE, 2, 1)),
        ((cs_mod.ADVICE, 1, 0), (cs_mod.ADVICE, 1, 3)),
    ]
    return cs, [q, tkeys, tvals], [adv0, keys, vals], [], copies


CIRCUITS = {"toy": toy_inputs, "pub": pub_inputs, "pair": pair_inputs}


@pytest.fixture(scope="module")
def srs():
    return get_srs(K, device="cpu")


@functools.lru_cache(maxsize=None)
def _keyed_and_proved(name: str):
    cs, fixed, advice, instances, copies = CIRCUITS[name](CS)
    pk = keygen(get_srs(K, device="cpu"), cs, fixed, copies, device="cpu")
    proof = create_proof(pk, advice, instances, rng=_det_rng(JAX_REF[name]["seed"]),
                         device="cpu")
    return name, pk, instances, proof


@pytest.fixture(scope="module", params=sorted(CIRCUITS))
def port_proof(request, srs):
    """(name, port pk, instances, port proof) per circuit, made once per
    process."""
    return _keyed_and_proved(request.param)


def test_vk_transcript_repr_matches_jax(port_proof):
    name, pk, _, _ = port_proof
    assert pk.vk.transcript_repr == JAX_REF[name]["transcript_repr"]


def test_proof_matches_jax_byte_for_byte(port_proof):
    name, _, _, proof = port_proof
    assert proof.hex() == JAX_REF[name]["proof"]


def test_port_verifier_accepts_jax_proof_and_rejects_tampering(port_proof, srs):
    name, pk, instances, _ = port_proof
    jax_proof = bytes.fromhex(JAX_REF[name]["proof"])
    assert verify_proof(pk.vk, srs, jax_proof, instances)
    bad = bytearray(jax_proof)
    bad[len(bad) // 2] ^= 1
    assert not verify_proof(pk.vk, srs, bytes(bad), instances)
    if instances:  # the proof is bound to its public inputs
        assert not verify_proof(pk.vk, srs, jax_proof, [[43, 99]])


@pytest.mark.parametrize("port_proof", ["toy", "pair"], indirect=True)
def test_serial_msm_route_gives_the_same_proof(port_proof, monkeypatch):
    """Committing through the serial Pippenger instead of the v3 pipeline
    gives the same commitments, so the same proof bytes."""
    from webauthn_halo2_tpu_torch.ops import msm as MS
    from webauthn_halo2_tpu_torch.plonk import keygen as KG

    name, pk, instances, _ = port_proof
    _, _, advice, _, _ = CIRCUITS[name](CS)
    monkeypatch.setattr(KG, "MSM_ENGINE", MS)
    calls = MS.CALLS["window_bucket_sum"]
    proof = create_proof(pk, advice, instances, rng=_det_rng(JAX_REF[name]["seed"]),
                         device="cpu")
    assert MS.CALLS["window_bucket_sum"] > calls
    assert proof.hex() == JAX_REF[name]["proof"]


# the MSMs of one proof, each folded by the v1 route's device Horner
V1_MSMS = {"pub": 5, "pair": 14}


@pytest.mark.parametrize("port_proof", sorted(V1_MSMS), indirect=True)
def test_v1_msm_route_gives_the_same_proof(port_proof, monkeypatch):
    """Committing through the v1 driver (one MSM at a time, the plain
    boundary scan of fused adds, the device Horner) gives the same
    commitments, so the same proof bytes. Each MSM folds about 250
    doublings on the device, so only the public-input circuit (five MSMs)
    and the two-column lookup circuit run it."""
    from webauthn_halo2_tpu_torch.ops import msm_v1 as V
    from webauthn_halo2_tpu_torch.plonk import keygen as KG

    name, pk, instances, _ = port_proof
    _, _, advice, _, _ = CIRCUITS[name](CS)
    monkeypatch.setattr(KG, "MSM_ENGINE", V)
    calls = []
    monkeypatch.setattr(V, "horner", lambda *a, h=V.horner: calls.append(1) or h(*a))
    proof = create_proof(pk, advice, instances, rng=_det_rng(JAX_REF[name]["seed"]),
                         device="cpu")
    assert len(calls) == V1_MSMS[name]
    assert proof.hex() == JAX_REF[name]["proof"]


@functools.lru_cache(maxsize=None)
def _keccak_proof(name: str, scheme: str) -> bytes:
    """The port's proof of `name` over the Keccak (EVM) transcript."""
    _, pk, instances, _ = _keyed_and_proved(name)
    _, _, advice, _, _ = CIRCUITS[name](CS)
    return create_proof(pk, advice, instances, rng=_det_rng(JAX_REF[name]["seed"]),
                        scheme=scheme, transcript=KeccakWrite(), device="cpu")


@pytest.mark.parametrize("scheme", ["gwc", "shplonk"])
def test_keccak_proof_matches_jax_byte_for_byte(port_proof, scheme):
    """GWC (the EVM route's default) and SHPLONK over the Keccak transcript:
    the same bytes as the JAX package's."""
    name = port_proof[0]
    assert _keccak_proof(name, scheme).hex() == JAX_REF[name]["keccak"][scheme]


@pytest.mark.parametrize("scheme", ["gwc", "shplonk"])
def test_port_verifier_accepts_jax_keccak_proof_and_rejects_tampering(port_proof, srs, scheme):
    name, pk, instances, _ = port_proof
    jax_proof = bytes.fromhex(JAX_REF[name]["keccak"][scheme])

    def verify(proof, inst):
        return verify_proof(pk.vk, srs, proof, inst, scheme=scheme,
                            transcript=KeccakRead(proof))

    assert verify(jax_proof, instances)
    bad = bytearray(jax_proof)
    bad[len(bad) // 2] ^= 1
    assert not verify(bytes(bad), instances)
    other = "shplonk" if scheme == "gwc" else "gwc"
    assert not verify_proof(pk.vk, srs, jax_proof, instances, scheme=other,
                            transcript=KeccakRead(jax_proof))
    if instances:
        assert not verify(jax_proof, [[43, 99]])


@pytest.mark.parametrize("port_proof", ["toy"], indirect=True)
def test_create_proof_rejects_an_unknown_scheme(port_proof):
    name, pk, instances, _ = port_proof
    _, _, advice, _, _ = CIRCUITS[name](CS)
    with pytest.raises(ValueError, match="bogus"):
        create_proof(pk, advice, instances, scheme="bogus", device="cpu")


def _host_eval(coeffs: list, x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % R
    return acc


@pytest.mark.parametrize("port_proof", ["toy"], indirect=True)
def test_gwc_w_divides_each_group(port_proof):
    """FusedPhases.gwc_w on random coefficient rows: for each rotation
    group, W(X) (X - z) + r_comb = F(X) at a random X, F the group's rows
    folded by Horner in v and r_comb = F(z), in host integers; the unified
    stack is left as it was (a group of one must not write into it)."""
    _, pk, _, _ = port_proof
    fp = FusedPhases(pk)
    n = pk.vk.domain.n
    gen = np.random.default_rng(8)

    def rand() -> int:
        return int.from_bytes(gen.bytes(32), "little") % R

    rows = [[rand() for _ in range(n)] for _ in range(fp.u_total)]
    ucoeff = torch.as_tensor(FR_SPEC.encode([c for row in rows for c in row])).reshape(
        8, fp.u_total, n)
    before = ucoeff.clone()
    groups = ((0,), (1, fp.u_total - 1, 2), (fp.u_h,))
    v, zs, x = rand(), [rand() for _ in groups], rand()
    folded, rcombs = [], []
    for members, z in zip(groups, zs):
        F = [0] * n
        for ui in members:
            F = [(f * v + c) % R for f, c in zip(F, rows[ui])]
        folded.append(F)
        rcombs.append(_host_eval(F, z))

    def mont(val):
        return torch.as_tensor(FR_SPEC.encode([val]))

    W_list = fp.gwc_w(groups, ucoeff, mont(v), [mont(r) for r in rcombs],
                      [mont(z) for z in zs])
    assert torch.equal(ucoeff, before)
    assert len(W_list) == len(groups)
    for W_t, F, z, r_comb in zip(W_list, folded, zs, rcombs):
        W_host = FR_SPEC.decode(W_t)
        assert (_host_eval(W_host, x) * (x - z) + r_comb) % R == _host_eval(F, x)


def _jax_outputs(name: str):
    """Key and prove `name` with the JAX package: (transcript_repr, proof,
    JAX vk, JAX srs, instances)."""
    from webauthn_halo2_tpu.plonk import cs as JCS
    from webauthn_halo2_tpu.plonk.keygen import keygen as jkeygen
    from webauthn_halo2_tpu.plonk.prover import create_proof as jcreate_proof
    from webauthn_halo2_tpu.plonk.srs import get_srs as jget_srs

    from webauthn_halo2_tpu.plonk.transcript import KeccakWrite as JKeccakWrite

    cs, fixed, advice, instances, copies = CIRCUITS[name](JCS)
    srs_ = jget_srs(K)
    pk = jkeygen(srs_, cs, fixed, copies)
    proof = jcreate_proof(pk, advice, instances,
                          rng=_det_rng(JAX_REF[name]["seed"]))
    keccak = {scheme: jcreate_proof(pk, advice, instances,
                                    rng=_det_rng(JAX_REF[name]["seed"]),
                                    scheme=scheme, transcript=JKeccakWrite())
              for scheme in ("gwc", "shplonk")}
    return pk.vk.transcript_repr, proof, pk.vk, srs_, instances, keccak


@pytest.mark.slow
def test_stored_jax_outputs_are_current(port_proof):
    """Regenerates JAX_REF live and has the JAX verifier accept the port's
    proofs, Blake2b and both Keccak ones (minutes: XLA:CPU compiles the
    JAX prover's graphs)."""
    from webauthn_halo2_tpu.plonk.transcript import KeccakRead as JKeccakRead
    from webauthn_halo2_tpu.plonk.verifier import verify_proof as jverify

    name, _, instances, proof = port_proof
    repr_, jproof, jvk, jsrs, _, keccak = _jax_outputs(name)
    assert repr_ == JAX_REF[name]["transcript_repr"]
    assert jproof.hex() == JAX_REF[name]["proof"]
    assert jverify(jvk, jsrs, proof, instances)
    for scheme, jk in keccak.items():
        assert jk.hex() == JAX_REF[name]["keccak"][scheme]
        port = _keccak_proof(name, scheme)
        assert jverify(jvk, jsrs, port, instances, scheme=scheme,
                       transcript=JKeccakRead(port))
